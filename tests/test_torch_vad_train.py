# SPDX-License-Identifier: Apache-2.0
"""The learned VAD's trainer and evaluator in the port against the
reference's ``tools/train_vad.py`` and ``tools/eval_vad.py``.

The reference tools are loaded by path, with ``SK_VAD_REAL_SPEECH`` (read at
import) pointing at the repo's own ``samples/media/speech_10m.ogg``. The
reference defines its loss and Adam step inside ``main``; the JAX side here
is the same expressions (``tools/train_vad.py:194-210``) on the JAX
package's ``silero_vad.apply`` and ``optax.adam(3e-4)``.

Tolerances (f32 on the CPU in both):
- data: audio, labels and weights equal exactly (numpy in both, the teacher
  labels from probabilities within ``TEACHER_ATOL`` of each other);
- loss within ``LOSS_RTOL`` relative; each gradient leaf within
  ``GRAD_RTOL`` of its largest |g| (XLA and ATen sum the batch's frames in
  different orders); accuracy within one weighted frame;
- Adam: params within 2·lr a step of optax's (a coordinate whose gradient
  is at rounding level may step either way: Adam normalises it to ±lr),
  99.9 % of them within ``PARAM_ATOL``;
- evaluator: every printed line equal, each number within one unit of its
  last printed digit.
"""

import hashlib
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from streamkit_tpu.models import silero_vad as jsv
from streamkit_tpu.ops import vad as jvad
from streamkit_tpu_torch.models import silero_vad as tsv
from streamkit_tpu_torch.ops import vad as tvad

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEECH_10M = os.path.join(REPO, "samples", "media", "speech_10m.ogg")
SPEECH_30S = os.path.join(REPO, "samples", "media", "speech_30s.ogg")
TEACHER_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-6
LR = 3e-4


def _have_opus() -> bool:
    from streamkit_tpu.nodes.codecs.opus import OpusLib

    try:
        OpusLib.get()
    except OSError:
        return False
    return True


needs_opus = pytest.mark.skipif(not _have_opus(), reason="libopus does not load")


def _load_tool(name: str, env: dict):
    """``tools/<name>.py`` as a fresh module, ``env`` set while it imports."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        spec = importlib.util.spec_from_file_location(f"_reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mod


@pytest.fixture(scope="module")
def tools():
    """(reference trainer, port trainer), both on ``speech_10m.ogg``."""
    jtv = _load_tool("train_vad", {"SK_VAD_REAL_SPEECH": SPEECH_10M})
    from streamkit_tpu_torch.tools import train_vad as ttv

    saved = ttv._REAL_SAMPLE, ttv._REAL
    ttv._REAL_SAMPLE, ttv._REAL = SPEECH_10M, None
    yield jtv, ttv
    ttv._REAL_SAMPLE, ttv._REAL = saved


def _seeded_params(seed: int = 0) -> dict:
    """``init_params(seed)`` with every bias drawn at random too: zero
    biases would hide a bias the port drops or adds twice."""
    params = jsv.init_params(seed)
    rng = np.random.default_rng(seed + 1)
    for name, v in params.items():
        if name.endswith(("_b", "_b1", "_b2")):
            params[name] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return params


def _jax_loss(params, audio, labels, weight):
    """The reference's ``loss_fn`` (``tools/train_vad.py:196-205``)."""
    frames = audio.reshape(audio.shape[0], 48, jsv.FRAME)
    state = jsv.init_state((audio.shape[0],))
    probs, _ = jsv.apply(params, state, frames)
    eps = 1e-6
    bce = -(labels * jnp.log(probs + eps) + (1 - labels) * jnp.log(1 - probs + eps))
    wsum = jnp.maximum(jnp.sum(weight), 1.0)
    acc = jnp.sum(((probs > 0.5) == (labels > 0.5)) * weight) / wsum
    return jnp.sum(bce * weight) / wsum, acc


_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_loss, has_aux=True))


# ---------------------------------------------------------------- data
@needs_opus
def test_real_speech_teacher_matches_jax(tools):
    """The decoded frames are equal; the spectral teacher's probabilities
    agree within ``TEACHER_ATOL`` and give the same speech / nonspeech /
    masked label on every frame. How many sit within 1e-5 of a threshold is
    counted: such a frame could flip its label between the packages."""
    jtv, ttv = tools
    jframes, jprobs = jtv._load_real()
    tframes, tprobs = ttv._load_real()
    assert tframes.shape == jframes.shape == (18750, 512)
    assert np.array_equal(tframes, jframes)
    err = float(np.abs(tprobs - jprobs).max())
    near = int((np.abs(jprobs - 0.8) < 1e-5).sum() + (np.abs(jprobs - 0.2) < 1e-5).sum())
    print(f"teacher max |Δp| {err:.3g}; {near} of {len(jprobs)} probabilities within 1e-5 of 0.8 or 0.2")
    assert err <= TEACHER_ATOL, err
    flips = int(((tprobs > 0.8) != (jprobs > 0.8)).sum() + ((tprobs < 0.2) != (jprobs < 0.2)).sum())
    assert flips == 0, f"{flips} teacher labels flip between the packages ({near} near a threshold)"


@needs_opus
@pytest.mark.parametrize("real", [True, False], ids=["with_real_speech", "synthetic_only"])
def test_make_dataset_matches_jax(tools, real, monkeypatch):
    jtv, ttv = tools
    if real:
        assert len(jtv._load_real()) and len(ttv._load_real())
    else:
        monkeypatch.setattr(jtv, "_REAL", ())
        monkeypatch.setattr(ttv, "_REAL", ())
    for seed in (0, 3):
        ja, jl, jw = jtv.make_dataset(24, seed)
        ta, tl, tw = ttv.make_dataset(24, seed)
        assert ta.shape == ja.shape == (24, 48 * 512) and ta.dtype == ja.dtype
        assert np.array_equal(tl, jl) and np.array_equal(tw, jw)
        assert np.array_equal(ta, ja)
        # real clips carry masked frames (weight 0); synthetic ones never do
        assert (tw == 0.0).any() if real else (tw == 1.0).all()


# ---------------------------------------------------------------- loss, grads, Adam
@needs_opus
def test_loss_and_gradients_match_jax_value_and_grad(tools):
    _, ttv = tools
    audio, labels, weight = ttv.make_dataset(8, seed=5)
    params = _seeded_params()
    (jloss, jacc), jgrads = _jax_value_and_grad(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(audio), jnp.asarray(labels), jnp.asarray(weight))
    tparams, _ = ttv.init_training("cpu", params=params)
    tloss, tacc = ttv.loss_fn(tparams, *ttv.to_device((audio, labels, weight), torch.device("cpu")))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (tloss.item(), float(jloss))
    n_weighted = float(weight.sum())
    assert abs(tacc.item() - float(jacc)) <= 1.0 / n_weighted + 1e-7, (tacc.item(), float(jacc))
    for name, g in jgrads.items():
        g = np.asarray(g)
        err = float(np.abs(tparams[name].grad.numpy() - g).max())
        assert err <= GRAD_RTOL * float(np.abs(g).max()), (name, err, float(np.abs(g).max()))


@needs_opus
def test_three_adam_steps_match_optax(tools):
    _, ttv = tools
    params = _seeded_params()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = optax.adam(LR)
    jstate = opt.init(jparams)
    tparams, topt = ttv.init_training("cpu", params=params)
    for step in range(3):
        batch = ttv.make_dataset(8, seed=10 + step)
        (jloss, _), grads = _jax_value_and_grad(jparams, *(jnp.asarray(a) for a in batch))
        updates, jstate = opt.update(grads, jstate)
        jparams = optax.apply_updates(jparams, updates)
        tloss, _ = ttv.train_step(tparams, topt, *ttv.to_device(batch, torch.device("cpu")))
        assert abs(tloss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), step
    diffs = [np.abs(tparams[k].detach().numpy() - np.asarray(v)) for k, v in jparams.items()]
    moved = max(float(np.abs(tparams[k].detach().numpy() - params[k]).max()) for k in params)
    assert moved > LR  # the steps did move the parameters
    assert max(float(d.max()) for d in diffs) <= 3 * 2 * LR
    near = sum(int((d <= PARAM_ATOL).sum()) for d in diffs) / sum(d.size for d in diffs)
    assert near >= 0.999, near


def test_the_port_trains_only_where_it_is_told():
    from streamkit_tpu_torch.tools import eval_vad, train_vad

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    for call in (lambda: train_vad.init_training(), lambda: train_vad.train(1),
                 lambda: eval_vad.evaluate(np.zeros(4096, np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@needs_opus
def test_main_writes_out_and_leaves_the_bundled_weights(tools, tmp_path, monkeypatch, capsys):
    _, ttv = tools
    with open(ttv.BUNDLED_WEIGHTS, "rb") as f:
        bundled = hashlib.sha256(f.read()).hexdigest()
    monkeypatch.setenv("SK_VAD_STEPS", "2")
    out = ttv.main(["--out", str(tmp_path / "vad.npz"), "--device", "cpu"])
    assert out == str(tmp_path / "vad.npz")
    params = jsv.load_params(out)  # the JAX package reads the port's file
    assert set(params) == set(jsv.PARAM_SHAPES)
    text = capsys.readouterr().out
    assert "step 0:" in text and "step 1:" in text and "saved" in text
    with open(ttv.BUNDLED_WEIGHTS, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == bundled


# ---------------------------------------------------------------- save / load
def test_params_round_trip_across_packages(tmp_path):
    params = _seeded_params(3)
    tsv.save_params({k: torch.from_numpy(v) for k, v in params.items()}, str(tmp_path / "port.npz"))
    jsv.save_params(params, str(tmp_path / "jax.npz"))
    from_port = jsv.load_params(str(tmp_path / "port.npz"))
    from_jax = tsv.load_params(str(tmp_path / "jax.npz"))
    for k, v in params.items():
        assert from_port[k].dtype == from_jax[k].dtype == np.float32
        assert np.array_equal(from_port[k], v) and np.array_equal(from_jax[k], v)


# ---------------------------------------------------------------- evaluator
_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?")


@needs_opus
def test_evaluator_matches_jax_on_speech_30s(monkeypatch, capsys):
    """The reference evaluator resets ``ops/vad.py``'s backend and sets
    ``SK_VAD_BACKEND``: both are restored after it. The port's evaluator
    touches neither."""
    monkeypatch.delenv("SK_VAD_WEIGHTS", raising=False)
    monkeypatch.delenv("SK_VAD_BACKEND", raising=False)
    for name in ("_BACKEND", "_LEARNED_APPLY"):
        monkeypatch.setattr(jvad, name, getattr(jvad, name))
    jev = _load_tool("eval_vad", {"SK_VAD_EVAL_SPEECH": SPEECH_30S})
    jev.main()
    want = capsys.readouterr().out.strip().splitlines()

    from streamkit_tpu_torch.tools import eval_vad

    backend, forced = tvad._BACKEND, os.environ.get("SK_VAD_BACKEND")
    eval_vad.report(eval_vad.evaluate(eval_vad.load_16k(SPEECH_30S), device="cpu"), SPEECH_30S)
    got = capsys.readouterr().out.strip().splitlines()
    assert tvad._BACKEND is backend and os.environ.get("SK_VAD_BACKEND") == forced
    assert len(got) == len(want) == 7, got
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        for a, b in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
            unit = 10.0 ** -len(b.split(".")[1]) if "." in b else 1.0
            assert abs(float(a) - float(b)) <= unit + 1e-9, (g, w)
