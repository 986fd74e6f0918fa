# SPDX-License-Identifier: Apache-2.0
"""The port's TTS stack against the JAX package's, on the CPU at f32.

VITS (``models/vits.py``), HiFi-GAN and the FastSpeech-style acoustic model
(``models/tts.py``) and the TTS node (``nodes/ml/tts_node.py``). Both
packages get the same numpy parameter tree (the reference's random init, or
one random transformers model converted by both) and the same seeded
inputs. Durations (frames per token) are equal exactly; waveforms, mels and
hidden states agree within 2e-5 (f32, the two libraries order their sums
differently); the node's audio within 1e-5.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamkit_tpu.models import tts as jtts
from streamkit_tpu.models import vits as jvits
from streamkit_tpu_torch.models import tts as ttts
from streamkit_tpu_torch.models import vits as tvits

torch.set_num_threads(2)

ATOL = 2e-5
TINY = dict(
    vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, ffn_dim=64, flow_size=16,
    upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
    resblock_dilation_sizes=((1, 3), (1, 3)), prior_encoder_num_flows=2, prior_encoder_num_wavenet_layers=2,
    duration_predictor_filter_channels=48, duration_predictor_num_flows=2,
)


def vits_pair(stochastic=True, **over):
    jc = jvits.VitsConfig(**dict(TINY, use_stochastic_duration_prediction=stochastic, **over))
    tc = tvits.VitsConfig(**dataclasses.asdict(jc))
    tree = jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape") else x, jvits.vits_init_params(jc, 0))
    return (jc, jvits.vits_init_params(jc, 0)), (tc, tvits.vits_params_from_numpy(tree, tc, device="cpu"))


def ids_and_mask(seed=1, b=3, t=16, lengths=(16, 9, 4), vocab=45):
    ids = np.random.RandomState(seed).randint(1, vocab, size=(b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.float32)
    for r, n in enumerate(lengths):
        mask[r, :n] = 1.0
        ids[r, n:] = 0
    return ids, mask


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j), atol=atol)


# -- VITS ------------------------------------------------------------------------
@pytest.mark.parametrize("stochastic", [True, False])
def test_vits_seeded_init_equals_the_reference_init(stochastic):
    """The port's init draws the reference's numbers; convolution weights
    come out in PyTorch's layout (the reference's [k, in, out] permuted)."""
    jc = jvits.VitsConfig(**dict(TINY, use_stochastic_duration_prediction=stochastic))
    tc = tvits.VitsConfig(**dataclasses.asdict(jc))
    want = jvits.vits_init_params(jc, 4)
    got = tvits.vits_init_params(tc, 4, device="cpu")
    leaves_w = jax.tree_util.tree_leaves(want)
    leaves_g = jax.tree_util.tree_leaves(got)
    assert len(leaves_w) == len(leaves_g)
    for w, g in zip(leaves_w, leaves_g):
        if isinstance(w, str):
            assert w == g
            continue
        w = np.asarray(w)
        assert np.array_equal(w.transpose(2, 1, 0) if w.ndim == 3 else w, g.numpy())


def test_vits_text_encoder_with_padding_matches_jax():
    """Hidden states and prior stats of a padded batch; ids past the
    vocabulary (the node's tokenizer gives up to 43 against 40 rows here)
    take the table's last row in both."""
    (jc, jp), (tc, tp) = vits_pair()
    ids, mask = ids_and_mask()
    assert ids.max() >= jc.vocab_size
    for a, b in zip(tvits.text_encoder(tp, tc, torch.as_tensor(ids), torch.as_tensor(mask)),
                    jvits.text_encoder(jp, jc, jnp.asarray(ids), jnp.asarray(mask))):
        close(a, b)


@pytest.mark.parametrize("stochastic", [True, False])
def test_vits_durations_and_flow_match_jax(stochastic):
    """Log durations within 2e-5 and the frames per token
    (``ceil(exp(log_dur) * mask / rate)``) equal exactly, at two speaking
    rates; the reverse prior flow within 2e-5."""
    (jc, jp), (tc, tp) = vits_pair(stochastic)
    ids, mask = ids_and_mask(seed=2)
    hj, mj, _ = jvits.text_encoder(jp, jc, jnp.asarray(ids), jnp.asarray(mask))
    ht, mt, _ = tvits.text_encoder(tp, tc, torch.as_tensor(ids), torch.as_tensor(mask))
    m_j, m_t = jnp.asarray(mask)[..., None], torch.as_tensor(mask)[..., None]
    lj = jvits.predict_durations(jp, jc, hj, m_j)
    lt = tvits.predict_durations(tp, tc, ht, m_t)
    close(lt, lj)
    for rate in (1.0, 1.3):
        dj = np.asarray(jnp.ceil(jnp.exp(lj) * m_j / rate))
        dt = tvits.durations(lt, m_t, rate).numpy()
        assert np.array_equal(dj, dt) and dt.sum() > 0
    z = np.random.RandomState(3).randn(3, 24, jc.flow_size).astype(np.float32)
    fm = (np.arange(24)[None, :, None] < np.array([24, 17, 5])[:, None, None]).astype(np.float32)
    close(tvits.flow_reverse(tp, tc, torch.as_tensor(z), torch.as_tensor(fm)),
          jvits.flow_reverse(jp, jc, jnp.asarray(z), jnp.asarray(fm)))


def test_vits_spline_matches_jax_on_bin_edges():
    """The rational-quadratic spline, with inputs on the bin edges
    themselves and outside the tail bound: the same bins, within 2e-5."""
    cfg = jvits.VitsConfig(**TINY)
    rng = np.random.RandomState(5)
    uw, uh = rng.randn(4, 7, 10).astype(np.float32), rng.randn(4, 7, 10).astype(np.float32)
    ud = rng.randn(4, 7, 9).astype(np.float32)
    x = rng.uniform(-6, 6, (4, 7)).astype(np.float32)
    # put some inputs exactly on the height edges the reverse pass searches
    h = np.asarray(jax.nn.softmax(jnp.asarray(uh), axis=-1))
    h = 1e-3 + (1 - 1e-3 * 10) * h
    edges = 2 * cfg.duration_predictor_tail_bound * np.concatenate([np.zeros((4, 7, 1)), np.cumsum(h, -1)], -1) - 5.0
    x[:, :3] = edges[:, :3, 4].astype(np.float32)
    args = (uw, uh, ud)
    close(tvits._rq_spline_reverse(torch.as_tensor(x), *map(torch.as_tensor, args), cfg),
          jvits._rq_spline_reverse(jnp.asarray(x), *map(jnp.asarray, args), cfg))


@pytest.mark.parametrize("rates,kernels", [((8, 8, 2, 2), (16, 16, 4, 4)), ((5, 5, 4, 2), (10, 10, 8, 4))])
def test_conv_transpose_matches_jax_at_every_stride(rates, kernels):
    """``lax.conv_transpose(transpose_kernel=True)`` with HF padding against
    ``conv_transpose1d`` with the kernel as [C_in, C_out, K] and padding
    (K - stride) // 2, at the strides of the VITS and FastSpeech vocoders."""
    rng = np.random.RandomState(0)
    for stride, k in zip(rates, kernels):
        x = rng.randn(2, 11, 6).astype(np.float32)
        w = rng.randn(k, 4, 6).astype(np.float32)  # the reference's [k, out, in]
        b = rng.randn(4).astype(np.float32)
        want = jvits._conv_transpose1d(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)}, stride)
        got = torch.nn.functional.conv_transpose1d(
            torch.as_tensor(x).transpose(1, 2), torch.as_tensor(w.transpose(2, 1, 0).copy()), torch.as_tensor(b),
            stride=stride, padding=(k - stride) // 2).transpose(1, 2)
        assert got.shape == want.shape == (2, 10 * stride - 2 * ((k - stride) // 2) + k, 4)
        close(got, want)


@pytest.mark.parametrize("stochastic", [True, False])
def test_vits_synthesize_matches_jax(stochastic):
    """Full synthesis at a fixed frame budget: the valid lengths equal, the
    waveforms within 2e-5; and the eager (tight) length."""
    (jc, jp), (tc, tp) = vits_pair(stochastic)
    ids, mask = ids_and_mask(seed=4)
    wj, nj = jvits.synthesize(jp, jc, jnp.asarray(ids), mask=jnp.asarray(mask), max_frames=96)
    wt, nt = tvits.synthesize(tp, tc, torch.as_tensor(ids), mask=torch.as_tensor(mask), max_frames=96)
    assert np.array_equal(np.asarray(nj), nt.numpy()) and nt.dtype == torch.int32
    assert wt.shape == (3, 96 * tc.hop)
    close(wt, wj)
    wj, nj = jvits.synthesize(jp, jc, jnp.asarray(ids[:1]))
    wt, nt = tvits.synthesize(tp, tc, torch.as_tensor(ids[:1]))
    assert int(nt[0]) == int(nj[0]) == wt.shape[1]
    close(wt, wj)


def test_vits_masked_batch_matches_single_row():
    """Two texts padded into one masked batch give each row's single-row
    synthesis (same frame budget): equal lengths, waveforms within 2e-5."""
    (_, _), (tc, tp) = vits_pair()
    ids, mask = ids_and_mask(seed=6, b=2, lengths=(12, 7))
    wb, nb = tvits.synthesize(tp, tc, torch.as_tensor(ids), mask=torch.as_tensor(mask), max_frames=64)
    for r in range(2):
        w1, n1 = tvits.synthesize(tp, tc, torch.as_tensor(ids[r:r + 1]), mask=torch.as_tensor(mask[r:r + 1]),
                                  max_frames=64)
        assert int(nb[r]) == int(n1[0])
        close(wb[r, : int(n1[0])], w1[0, : int(n1[0])].numpy())


@pytest.mark.parametrize("stochastic", [True, False])
def test_vits_hf_converter_and_loader_match_jax(stochastic, tmp_path):
    """One random transformers ``VitsModel`` (weight-norm parametrizations
    included): both converters give the same synthesis; ``load_vits`` reads
    its ``save_pretrained`` dir with a ``vocab.json``."""
    import json

    import transformers

    hf_cfg = transformers.VitsConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, window_size=4, ffn_dim=64,
        ffn_kernel_size=3, flow_size=16, spectrogram_bins=65, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
        upsample_initial_channel=32, resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
        prior_encoder_num_flows=2, prior_encoder_num_wavenet_layers=2, duration_predictor_filter_channels=48,
        duration_predictor_flow_bins=6, duration_predictor_num_flows=2, depth_separable_channels=2,
        depth_separable_num_layers=2, use_stochastic_duration_prediction=stochastic, noise_scale=0.0,
        noise_scale_duration=0.0, speaking_rate=1.0,
    )
    torch.manual_seed(7)
    model = transformers.VitsModel(hf_cfg).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jc, tc = jvits.vits_config_from_hf(hf_cfg), tvits.vits_config_from_hf(hf_cfg)
    jp, tp = jvits.vits_params_from_hf(sd, jc), tvits.vits_params_from_hf(sd, tc, device="cpu")
    ids = np.random.RandomState(0).randint(1, 40, size=(1, 13)).astype(np.int32)
    wj, nj = jvits.synthesize(jp, jc, jnp.asarray(ids))
    wt, nt = tvits.synthesize(tp, tc, torch.as_tensor(ids))
    assert int(nt[0]) == int(nj[0])
    close(wt, wj)
    with torch.no_grad():
        ref = model(torch.as_tensor(ids, dtype=torch.long)).waveform.numpy()
    assert ref.shape[-1] == int(nt[0])
    close(wt, ref, atol=2e-4)  # the reference's own tolerance against transformers
    model.save_pretrained(str(tmp_path))
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump({c: i + 1 for i, c in enumerate("abcdefghij")}, f)
    cfg, params, tok = tvits.load_vits(str(tmp_path), device="cpu")
    assert cfg == tc and tok.encode("Abc!").tolist() == [0, 1, 0, 2, 0, 3, 0]
    close(tvits.synthesize(params, cfg, torch.as_tensor(ids))[0], wj)


# -- HiFi-GAN and the acoustic model --------------------------------------------------
@pytest.mark.parametrize("rates,kernels", [((4, 4), (8, 8)), ((5, 5, 4, 2), (10, 10, 8, 4))])
def test_hifigan_matches_jax(rates, kernels):
    jc = jtts.HifiGanConfig(model_in_dim=20, upsample_initial_channel=64, upsample_rates=rates,
                            upsample_kernel_sizes=kernels, resblock_kernel_sizes=(3, 5),
                            resblock_dilation_sizes=((1, 3), (1, 3)))
    tc = ttts.HifiGanConfig(**dataclasses.asdict(jc))
    jp = jtts.hifigan_init_params(jc, 1)
    tp = ttts.hifigan_init_params(tc, 1, device="cpu")
    mel = np.random.RandomState(0).randn(2, 13, 20).astype(np.float32)
    got = ttts.hifigan_generate(tp, tc, torch.as_tensor(mel))
    want = jtts.hifigan_generate(jp, jc, jnp.asarray(mel))
    assert got.shape == want.shape and got.shape[1] >= 13 * int(np.prod(rates))
    close(got, want)
    tree = jax.tree.map(np.asarray, jp)
    assert torch.equal(ttts.hifigan_params_from_numpy(tree, tc, device="cpu")["ups"][0]["w"], tp["ups"][0]["w"])


def test_hifigan_hf_converter_matches_jax():
    import transformers

    small = dict(model_in_dim=20, upsample_initial_channel=64, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))
    hf_cfg = transformers.SpeechT5HifiGanConfig(**{k: list(v) if isinstance(v, tuple) else v for k, v in small.items()},
                                                normalize_before=True)
    hf_cfg.resblock_dilation_sizes = [list(d) for d in small["resblock_dilation_sizes"]]
    torch.manual_seed(0)
    model = transformers.SpeechT5HifiGan(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jc, tc = jtts.HifiGanConfig(**small), ttts.HifiGanConfig(**small)
    mel = np.random.RandomState(0).randn(40, 20).astype(np.float32)
    got = ttts.hifigan_generate(ttts.hifigan_params_from_hf(sd, tc, device="cpu"), tc, torch.as_tensor(mel[None]))
    close(got, jtts.hifigan_generate(jtts.hifigan_params_from_hf(sd, jc), jc, jnp.asarray(mel[None])))
    with torch.no_grad():
        close(got[0], model(torch.as_tensor(mel)).numpy(), atol=2e-4)


def test_acoustic_model_matches_jax():
    jc = jtts.AcousticConfig(d_model=64, heads=2, enc_layers=2, dec_layers=2, n_mels=20)
    tc = ttts.AcousticConfig(**dataclasses.asdict(jc))
    jp, tp = jtts.acoustic_init_params(jc, 0), ttts.acoustic_init_params(tc, 0, device="cpu")
    for text, frames in ((b"hello world", 64), (b"a longer sentence, with punctuation!", 200)):
        toks = np.frombuffer(text, np.uint8)[None].astype(np.int32)
        toks = np.concatenate([toks, toks[:, ::-1]])
        close(ttts.acoustic_generate(tp, tc, torch.as_tensor(toks), frames),
              jtts.acoustic_generate(jp, jc, jnp.asarray(toks), frames))


# -- the TTS node ------------------------------------------------------------------
SENTENCES = ["Hi there. A first", " chunk, then more!", " A tail"]


def run_tts(pkg, params, texts, batcher=None, n_sessions=1):
    """``n_sessions`` concurrent TTS nodes fed ``texts`` → each one's audio
    (float32 samples) and its frames' sample rate. ``batcher`` is started
    and stopped inside the run."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    node_cls = importlib.import_module(f"{pkg}.nodes.ml.tts_node").TtsNode

    async def main():
        resources = core.ResourceManager()
        outs = [None] * n_sessions
        if batcher is not None:
            batcher.start()

        async def one(i):
            node = node_cls(params, device="cpu") if pkg.endswith("torch") else node_cls(params)
            in_ch, out_ch = core.Channel(16), core.Channel(8192)
            ctx = core.NodeContext(node_name=f"t{i}", inputs={"in": in_ch},
                                   output=core.OutputSender(f"t{i}", direct={"out": out_ch}),
                                   batcher=batcher, resources=resources)
            task = asyncio.ensure_future(node.run(ctx))
            for text in texts:
                await in_ch.send(core.Packet.new_text(text))
            in_ch.close()
            await task
            out_ch.close()
            chunks, rate = [], None
            while (pkt := await out_ch.recv_optional()) is not None:
                chunks.append(np.asarray(pkt.audio.samples, np.float32))
                rate = pkt.audio.format.sample_rate
            outs[i] = (np.concatenate(chunks), rate)

        await asyncio.gather(*(one(i) for i in range(n_sessions)))
        if batcher is not None:
            batcher.stop()
        return outs

    return asyncio.run(main())


@pytest.mark.parametrize("backend", ["vits", "fastspeech"])
def test_tts_node_audio_matches_jax(backend):
    """Both backends without a checkpoint (the reference's random models):
    the same samples count and rate, audio within 1e-5; the VITS backend
    also through the port's ``DeviceBatcher`` (2 sessions share its
    ``tts_vits`` kind) against the JAX node's batched route."""
    from streamkit_tpu.engine.batcher import DeviceBatcher as JaxBatcher
    from streamkit_tpu_torch.engine import DeviceBatcher

    params = {"backend": backend, "sample_rate": 24000}
    (want, rate_j), = run_tts("streamkit_tpu", params, SENTENCES)
    (got, rate_t), = run_tts("streamkit_tpu_torch", params, SENTENCES)
    assert rate_t == rate_j == 24000 and got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, atol=1e-5)
    if backend == "vits":
        (want_b, _), = run_tts("streamkit_tpu", params, SENTENCES, batcher=JaxBatcher(tick_ms=20.0))
        tb = DeviceBatcher(tick_ms=100.0, device="cpu")  # a tick wide enough that both sessions share it
        outs = run_tts("streamkit_tpu_torch", params, SENTENCES, batcher=tb, n_sessions=2)
        for got_b, _ in outs:
            assert got_b.shape == want_b.shape
            np.testing.assert_allclose(got_b, want_b, atol=1e-5)
        kinds = tb.stats()["kinds"]
        assert kinds and all(k.startswith("tts_vits:randinit:1.0:") for k in kinds)
        assert sum(v["items"] for v in kinds.values()) == 6 > sum(v["calls"] for v in kinds.values())


def test_tts_node_refuses_the_kokoro_backend(tmp_path):
    """The kokoro backend (``backend: kokoro``, or ``auto`` on a dir holding
    ``voices.bin``) is picked at construction and refuses, when it loads, a
    model that is not a Kokoro dir: none at all (``ConfigurationError``) or
    one without ``tokens.txt`` (``FileNotFoundError``, as the reference's
    loader raises), with no fallback to another backend. Kokoro synthesis
    itself is held against the JAX package in ``test_torch_kokoro.py``."""
    from streamkit_tpu.nodes.ml.tts_node import TtsNode as JaxTtsNode
    from streamkit_tpu_torch.core import ConfigurationError, NodeRegistry
    from streamkit_tpu_torch.nodes import register_nodes
    from streamkit_tpu_torch.nodes.ml.tts_node import TtsNode

    assert TtsNode({"backend": "kokoro", "model_dir": str(tmp_path)}, device="cpu")._pick_backend() == "kokoro"
    with pytest.raises(ConfigurationError, match="kokoro backend requires a model dir"):
        run_tts("streamkit_tpu_torch", {"backend": "kokoro"}, ["hello."])
    (tmp_path / "voices.bin").write_bytes(b"\0" * 16)
    reg = NodeRegistry()
    register_nodes(reg, device="cpu")
    for kind in ("plugin::native::kokoro", "plugin::native::piper"):
        node = reg.create_node(kind, {"model_dir": str(tmp_path)})
        assert node._pick_backend() == JaxTtsNode({"model_dir": str(tmp_path)})._pick_backend() == "kokoro"
    for pkg in ("streamkit_tpu", "streamkit_tpu_torch"):
        with pytest.raises(FileNotFoundError, match="missing tokens.txt"):
            run_tts(pkg, {"model_dir": str(tmp_path)}, ["hello."])
    (tmp_path / "voices.bin").unlink()
    (tmp_path / "config.json").write_text("{}")
    assert TtsNode({"model_dir": str(tmp_path)}, device="cpu")._pick_backend() == "vits"
    assert TtsNode(None, device="cpu")._pick_backend() == "fastspeech"
    with pytest.raises(ConfigurationError, match="unknown tts backend"):
        TtsNode({"backend": "matcha"}, device="cpu")
