# SPDX-License-Identifier: Apache-2.0
"""Whisper fine-tuning: the port's ``parallel/train.py`` and
``utils/checkpoint.py`` against the JAX package's ``parallel/train.py`` on
the CPU, one device (the reference's mesh is not ported yet).

The config takes the models' flash gate in both attention kinds (T = 256,
head dim 64; cross-attention at 256 tokens); on the CPU both packages run
plain attention there, and on the card the port runs K1 and its backward
kernels (tests/test_torch_kernels_cuda.py, chip_smoke.py's ``# train``).

Tolerances (f32): the loss within 1e-5 relative; each gradient leaf within
1e-4 of that leaf's largest |g|; params after AdamW steps within 3·lr
absolute (a gradient near zero may take Adam's ±lr step with either sign)
with at least 99.9% of the elements within 1e-6."""

import numpy as np
import pytest
import torch

import jax

from streamkit_tpu.models.whisper.config import WhisperConfig as JaxWhisperConfig
from streamkit_tpu.models.whisper.model import init_params as jax_init_params
from streamkit_tpu.parallel import train as jtrain
from streamkit_tpu_torch.models.whisper.config import WhisperConfig
from streamkit_tpu_torch.models.whisper.load import params_from_numpy
from streamkit_tpu_torch.ops import attention as tattn
from streamkit_tpu_torch.parallel import (
    TrainState,
    init_train_state,
    loss_fn,
    make_train_step,
    train_state_from_numpy,
)
from streamkit_tpu_torch.utils.checkpoint import (
    latest_step,
    load_params,
    load_train_state,
    save_params,
    save_train_state,
)

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

DIMS = dict(n_mels=80, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2, n_vocab=512,
            n_text_ctx=256, n_text_state=128, n_text_head=2, n_text_layer=2)
CFG = WhisperConfig(**DIMS)
JCFG = JaxWhisperConfig(**DIMS)
LR = 1e-3
B, T = 2, 256


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    mel = (rng.randn(B, 2 * CFG.n_audio_ctx, CFG.n_mels) * 0.3).astype(np.float32)
    tin = rng.randint(0, CFG.n_vocab, (B, T)).astype(np.int32)
    tout = rng.randint(0, CFG.n_vocab, (B, T)).astype(np.int32)
    mask = (rng.rand(B, T) < 0.8).astype(np.float32)
    return mel, tin, tout, mask


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(0))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _leaves(params):
    """The port's params as {dotted path: numpy}."""
    return {name: p.detach().numpy() for name, p in params.named_parameters()}


def _jax_leaves(tree):
    """A JAX tree as {dotted path: numpy}, with the port's names."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in flat}


def _assert_params_close(got, want):
    assert set(got) == set(want)
    near = total = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 3 * LR, (name, diff.max())
        near += int((diff <= 1e-6).sum())
        total += diff.size
    assert near >= 0.999 * total, near / total


def test_loss_and_grads_match_jax(batch, jax_params):
    """``loss_fn`` and its gradients, every leaf, against ``jax.value_and_grad``
    of the reference's ``loss_fn``."""
    mel, tin, tout, mask = batch
    want_loss, want_grads = jax.value_and_grad(jtrain.loss_fn)(jax_params, JCFG, mel, tin, tout, mask)
    params = params_from_numpy(_numpy_tree(jax_params), CFG, device="cpu")
    state = init_train_state(params, LR)
    loss = loss_fn(state.params, CFG, *_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = {name: p.grad.numpy() for name, p in params.named_parameters()}
    want = _jax_leaves(want_grads)
    assert set(grads) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


def test_three_steps_match_jax(batch, jax_params):
    """Three steps of ``make_train_step`` (AdamW at lr 1e-3): the losses and
    the params after each, against the reference's jitted step."""
    jstep = jax.jit(jtrain.make_train_step(JCFG, lr=LR))
    jstate = jtrain.init_train_state(jax_params, lr=LR)
    state = init_train_state(params_from_numpy(_numpy_tree(jax_params), CFG, device="cpu"), LR)
    step = make_train_step(CFG, lr=LR)
    for i in range(3):
        jstate, want_loss = jstep(jstate, *batch)
        state, loss = step(state, *_torch_batch(batch))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, err_msg=f"step {i}")
        _assert_params_close(_leaves(state.params), _jax_leaves(jstate.params))
    assert state.step == int(jstate.step) == 3


def test_step_from_carried_jax_state_matches_jax(batch, jax_params):
    """A JAX train state after two steps, carried across with
    ``train_state_from_numpy`` (params and optax's mu, nu and count), takes
    one more step in both packages: equal loss, params and moments."""
    jstep = jax.jit(jtrain.make_train_step(JCFG, lr=LR))
    jstate = jtrain.init_train_state(jax_params, lr=LR)
    for _ in range(2):
        jstate, _ = jstep(jstate, *batch)
    adam = jstate.opt_state[0]  # optax.adamw: (ScaleByAdamState, decay, lr)
    state = train_state_from_numpy(_numpy_tree(jstate.params), _numpy_tree(adam.mu), _numpy_tree(adam.nu),
                                   int(adam.count), CFG, lr=LR, device="cpu")
    assert state.step == 2
    jstate, want_loss = jstep(jstate, *batch)
    state, loss = make_train_step(CFG, lr=LR)(state, *_torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_params_close(_leaves(state.params), _jax_leaves(jstate.params))
    adam = jstate.opt_state[0]
    mu, nu = _jax_leaves(adam.mu), _jax_leaves(adam.nu)
    for name, p in state.params.named_parameters():
        st = state.opt_state.state[p]
        assert float(st["step"]) == int(adam.count) == 3
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name], atol=1e-4 * np.abs(mu[name]).max(), rtol=0)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name], atol=1e-4 * np.abs(nu[name]).max(),
                                   rtol=0)


def test_loss_descends_over_five_steps():
    """The reference's ``test_sharded_train_step_runs_and_descends`` without
    a mesh: constant targets, lr 1e-3, five steps."""
    rng = np.random.RandomState(1)
    mel = torch.from_numpy((rng.randn(8, 2 * 64, 80) * 0.3).astype(np.float32))
    cfg = WhisperConfig(n_audio_ctx=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_vocab=512,
                        n_text_ctx=16, n_text_state=64, n_text_head=4, n_text_layer=2)
    tin, tout = torch.full((8, 8), 5), torch.full((8, 8), 7)
    state = init_train_state(params_from_numpy(_numpy_tree(jax_init_params(
        JaxWhisperConfig(**{f: getattr(cfg, f) for f in DIMS}), jax.random.PRNGKey(2))), cfg, device="cpu"), LR)
    step = make_train_step(cfg, lr=LR)
    losses = []
    for _ in range(5):
        state, loss = step(state, mel, tin, tout, torch.ones(8, 8))
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
    assert state.step == 5


def _fresh_state(jax_params):
    return init_train_state(params_from_numpy(_numpy_tree(jax_params), CFG, device="cpu"), LR)


def test_resume_is_bit_exact(batch, jax_params, tmp_path):
    """Two steps, ``save_train_state``, ``load_train_state``, one step equals
    three steps straight, bit for bit (params, moments, step counts)."""
    step = make_train_step(CFG, lr=LR)
    tb = _torch_batch(batch)
    straight = _fresh_state(jax_params)
    for _ in range(3):
        straight, want_loss = step(straight, *tb)
    state = _fresh_state(jax_params)
    for _ in range(2):
        state, _ = step(state, *tb)
    path = save_train_state(str(tmp_path), state)
    assert path.endswith("step_2") and latest_step(str(tmp_path)) == 2
    resumed = load_train_state(str(tmp_path), _fresh_state(jax_params))
    assert isinstance(resumed, TrainState) and resumed.step == 2
    resumed, loss = step(resumed, *tb)
    assert loss.item() == want_loss.item() and resumed.step == 3
    for (name, p), q in zip(resumed.params.named_parameters(), straight.params.parameters()):
        assert torch.equal(p, q), name
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(resumed.opt_state.state[p][key], straight.opt_state.state[q][key]), (name, key)


def test_params_roundtrip_into_the_templates_dtype(jax_params, tmp_path):
    """``save_params`` / ``load_params``: the latest step by default, each
    leaf restored into the template's dtype; the reference's layout
    (``step_N``)."""
    params = params_from_numpy(_numpy_tree(jax_params), CFG, device="cpu")
    save_params(str(tmp_path), params, step=1)
    path = save_params(str(tmp_path), params, step=3)
    assert path == str(tmp_path / "step_3") and latest_step(str(tmp_path)) == 3
    restored = load_params(str(tmp_path), params)
    for (name, a), b in zip(params.named_parameters(), restored.parameters()):
        assert torch.equal(a, b) and not b.requires_grad, name
    half = load_params(str(tmp_path), params_from_numpy(_numpy_tree(jax_params), CFG, torch.bfloat16, "cpu"),
                       step=1)
    for a, b in zip(params.parameters(), half.parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)


def test_missing_checkpoint_raises(jax_params, tmp_path):
    params = params_from_numpy(_numpy_tree(jax_params), CFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "nope"), params)
    with pytest.raises(FileNotFoundError):
        load_train_state(str(tmp_path), init_train_state(params, LR))
    assert latest_step(str(tmp_path / "nope")) is None


def test_cpu_train_step_launches_no_kernel(batch, jax_params):
    """On the CPU the train step differentiates the plain attention: no K1
    forward or backward launch is counted."""
    counts = (tattn.flash_attention.launches, tattn._bwd_preprocess.launches,
              tattn._bwd_main.launches)
    make_train_step(CFG, lr=LR)(_fresh_state(jax_params), *_torch_batch(batch))
    assert counts == (tattn.flash_attention.launches, tattn._bwd_preprocess.launches,
                      tattn._bwd_main.launches)
