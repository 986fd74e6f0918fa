# SPDX-License-Identifier: Apache-2.0
"""The port's mesh against the JAX package's (tests/test_parallel.py and
tests/test_checkpoint.py::test_sharded_params_roundtrip): the JAX side runs
in this process on the 8-device CPU mesh of tests/conftest.py, the port's on
8 gloo ranks spawned by ``parallel.run_ranks``.

The ranks import this module, so it imports only the port at its top (the
JAX package is imported inside the fixtures). One spawn runs every scenario
of the file (a spawn of 8 ranks costs seconds); each test asserts on its own
part of the result. The ranks also run the port's one-rank version of each
path (rank 0, no collective) so the mesh is held against both.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from streamkit_tpu_torch.models.marian import MarianConfig, marian_greedy_cached, marian_params_from_numpy
from streamkit_tpu_torch.models.nllb import NllbConfig, nllb_greedy_cached, nllb_params_from_numpy
from streamkit_tpu_torch.models.whisper.config import WhisperConfig
from streamkit_tpu_torch.models.whisper.load import params_from_numpy
from streamkit_tpu_torch.models.whisper.model import decode_logits, encode
from streamkit_tpu_torch.ops.tensor_parallel import tp_of, whole_leaf
from streamkit_tpu_torch.parallel import (
    gather_params,
    init_train_state,
    make_mesh,
    make_train_step,
    run_ranks,
    seq2seq_param_sharding,
    shard_batch,
    shard_params,
    whisper_param_sharding,
)
from streamkit_tpu_torch.parallel.dryrun import dryrun_multichip
from streamkit_tpu_torch.utils.checkpoint import load_params, load_train_state, save_params, save_train_state

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

DIMS = dict(n_audio_ctx=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_vocab=512, n_text_ctx=16,
            n_text_state=64, n_text_head=4, n_text_layer=2)
TINY = WhisperConfig(**DIMS)
# three heads of 32: the width divides by tp = 2, the heads do not
ODD_DIMS = dict(DIMS, n_audio_state=96, n_audio_head=3, n_text_state=96, n_text_head=3)
CKPT_DIMS = dict(n_audio_ctx=16, n_audio_state=64, n_audio_head=2, n_audio_layer=1, n_vocab=128, n_text_ctx=8,
                 n_text_state=64, n_text_head=2, n_text_layer=1)
SEQ2SEQ_DIMS = dict(vocab_size=128, d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
                    max_positions=64)
NLLB = NllbConfig(**SEQ2SEQ_DIMS)
MARIAN_IDS = dict(pad_token_id=127, decoder_start_token_id=127, eos_token_id=0)
MARIAN = MarianConfig(**SEQ2SEQ_DIMS, **MARIAN_IDS)
LR = 1e-3
WORLD = 8
DEADLINE_S = 120


def affine_random(tree, seed: int):
    """``tree`` (numpy) with every leaf that the init sets to one constant
    (biases, layer-norm gains and shifts, Marian's ``logits_bias``) moved
    off it by seeded noise of 0.1: a bias added once per tp rank, or the
    wrong block of a split bias, then shows in every comparison."""
    rng = np.random.RandomState(seed)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        x = np.asarray(x)
        if x.size and (x == x.flat[0]).all():
            return (x + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        return x

    return walk(tree)


def _placement_name(p) -> str:
    return f"Shard({p.dim})" if hasattr(p, "dim") else "Replicate()"


def _flat_placements(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat_placements(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat_placements(sub, path + (i,)).items()}
    return {".".join(map(str, path)): _placement_name(tree)}


def _rows_of_dp(x: torch.Tensor, mesh) -> np.ndarray:
    """Every dp rank's rows of ``x``, gathered in rank order (host numpy)."""
    group = mesh.get_group("dp")
    parts = [torch.empty_like(x) for _ in range(mesh.size(0))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts).numpy()


def _leaves(params) -> dict:
    return {n: p.detach().clone() for n, p in params.named_parameters()}


def _whole_grads(params) -> dict:
    """Every leaf's gradient, split ones gathered over tp."""
    return {n: p.grad.clone() if tp_of(p) is None else whole_leaf(p.grad, tp_of(p))
            for n, p in params.named_parameters()}


def _whole_moments(state) -> dict:
    """Every leaf's AdamW moments (exp_avg, exp_avg_sq), split ones gathered
    over tp."""
    out = {}
    for n, p in state.params.named_parameters():
        m = state.opt_state.state[p]
        out[n] = tuple(m[k].clone() if tp_of(p) is None else whole_leaf(m[k], tp_of(p))
                       for k in ("exp_avg", "exp_avg_sq"))
    return out


def _scenarios(inp: dict) -> dict:
    """Every scenario of the file on this rank; rank 0 returns the results."""
    rank = dist.get_rank()
    out = {}

    # mesh shapes and the refusal
    mesh = make_mesh(WORLD, tp=2, device="cpu")
    out["mesh"] = (tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names))
    try:
        make_mesh(WORLD, tp=3, device="cpu")
    except ValueError as e:
        out["tp3"] = str(e)

    # layouts: placements per leaf under the reference's paths
    out["layout"] = {
        name: _flat_placements(whisper_param_sharding(mesh, params_from_numpy(tree, cfg, device="cpu"), cfg))
        for name, (tree, cfg) in {"tiny": (inp["fwd_params"], TINY),
                                  "odd_heads": (inp["odd_params"], WhisperConfig(**ODD_DIMS))}.items()
    }

    # sharded forward against the one-rank forward
    full = params_from_numpy(inp["fwd_params"], TINY, device="cpu")
    local = shard_params(mesh, full, TINY)
    mel, tokens = (torch.from_numpy(a) for a in inp["fwd_inputs"])
    with torch.no_grad():
        m, t = shard_batch(mesh, mel, tokens)
        logits = _rows_of_dp(decode_logits(local, TINY, t, encode(local, TINY, m)), mesh)
        one = decode_logits(full, TINY, tokens, encode(full, TINY, mel)).numpy() if rank == 0 else None
    out["forward"] = (logits, one)
    out["q_local_shape"] = tuple(local["enc"]["layers"][0]["attn"]["q"]["w"].shape)

    # sharded train step: 5 steps, the first held against the one-rank step
    mel, tin, tout, mask = (torch.from_numpy(a) for a in inp["train_batch"])
    state = init_train_state(shard_params(mesh, params_from_numpy(inp["train_params"], TINY, device="cpu"), TINY),
                             lr=LR)
    step = make_train_step(TINY, lr=LR, mesh=mesh)
    rows = shard_batch(mesh, mel, tin, tout, mask)
    losses = []
    for i in range(5):
        state, loss = step(state, *rows)
        losses.append(float(loss))
        if i == 0:
            after_one = _leaves(gather_params(state.params))
            grads_one = _whole_grads(state.params)
            moments_one = _whole_moments(state)
            save_train_state(inp["tmp"] + "/train", state)
    out["train"] = {"losses": losses, "step": state.step}
    if rank == 0:
        ref = init_train_state(params_from_numpy(inp["train_params"], TINY, device="cpu"), lr=LR)
        ref, ref_loss = make_train_step(TINY, lr=LR)(ref, mel, tin, tout, mask)
        want = _leaves(ref.params)
        ref_grads = {n: p.grad for n, p in ref.params.named_parameters()}
        out["train"]["one_rank_loss"] = float(ref_loss)
        out["train"]["grad_gap"] = max(float((grads_one[k] - ref_grads[k]).abs().max()) for k in want)
        # AdamW's first step moves a leaf by lr·g/(|g| + 1e-8): where |g| is
        # near 1e-8 the step turns on the last bits of g, so those elements
        # are held to the step's own bound instead
        gap = {k: (after_one[k] - want[k]).abs().numpy() for k in want}
        steep = {k: ref_grads[k].abs().numpy() <= 1e-5 for k in want}
        out["train"]["param_gap"] = max(float(gap[k][~steep[k]].max(initial=0.0)) for k in want)
        out["train"]["steep_gap"] = max(float(gap[k][steep[k]].max(initial=0.0)) for k in want)
        out["train"]["steep_count"] = int(sum(int(m.sum()) for m in steep.values()))
        # the moments are linear in g and g², so they hold those elements
        # tightly: each moment's gap in units of g, (m₁ − m₁')/(1 − β₁) and
        # (√m₂ − √m₂')/√(1 − β₂)
        b1, b2 = ref.opt_state.param_groups[0]["betas"]
        ref_moments = _whole_moments(ref)
        out["train"]["moment_gap"] = max(
            max(float((moments_one[k][0] - ref_moments[k][0]).abs().max()) / (1 - b1),
                float((moments_one[k][1].sqrt() - ref_moments[k][1].sqrt()).abs().max()) / (1 - b2) ** 0.5)
            for k in want)
        # the mesh's train state, loaded on one device
        back = load_train_state(inp["tmp"] + "/train", ref)
        got = _leaves(back.params)
        out["train"]["ckpt_param_gap"] = max(float((got[k] - after_one[k]).abs().max()) for k in want)
        moments = [(back.opt_state.state[p]["exp_avg"], ref.opt_state.state[q]["exp_avg"])
                   for p, q in zip(back.params.parameters(), ref.params.parameters())]
        out["train"]["ckpt_moment_gap"] = max(float((a - b).abs().max()) for a, b in moments)
        out["train"]["ckpt_step"] = back.step
    dist.barrier()

    # NLLB cached greedy at tp = 2 against the one-rank decode
    params = nllb_params_from_numpy(inp["nllb_params"], NLLB, device="cpu")
    placements = _flat_placements(seq2seq_param_sharding(mesh, params, NLLB))
    out["nllb_layout"] = {k: placements[k] for k in ("dec_layers.0.attn.q.w", "dec_layers.0.attn.o.w", "emb",
                                                     "enc_ln.g")}
    src = torch.from_numpy(inp["nllb_src"])
    with torch.no_grad():
        (s,) = shard_batch(mesh, src)
        toks, lens = nllb_greedy_cached(shard_params(mesh, params, NLLB), NLLB, s, 5, max_tokens=8)
        out["nllb"] = (_rows_of_dp(toks, mesh), _rows_of_dp(lens, mesh))
        if rank == 0:
            out["nllb_one"] = tuple(x.numpy() for x in nllb_greedy_cached(params, NLLB, src, 5, max_tokens=8))

    # Marian cached greedy at tp = 2 (its vocab-split logits_bias too)
    params = marian_params_from_numpy(inp["marian_params"], MARIAN, device="cpu")
    local = shard_params(mesh, params, MARIAN)
    out["marian_layout"] = _flat_placements(seq2seq_param_sharding(mesh, params, MARIAN))["logits_bias"]
    with torch.no_grad():
        toks, lens = marian_greedy_cached(local, MARIAN, s, max_tokens=8)
        out["marian"] = (_rows_of_dp(toks, mesh), _rows_of_dp(lens, mesh))
        if rank == 0:
            out["marian_one"] = tuple(x.numpy() for x in marian_greedy_cached(params, MARIAN, src, max_tokens=8))

    # sharded checkpoint: bit for bit, placements kept; it loads on one device
    ckpt_cfg = WhisperConfig(**CKPT_DIMS)
    full = params_from_numpy(inp["ckpt_params"], ckpt_cfg, device="cpu")
    local = shard_params(mesh, full, ckpt_cfg)
    save_params(inp["tmp"] + "/params", local, step=0)
    restored = load_params(inp["tmp"] + "/params", local)
    pairs = list(zip(local.named_parameters(), restored.named_parameters()))
    out["ckpt"] = {
        "bit_equal": all(torch.equal(a, b) for (_, a), (_, b) in pairs),
        "placements_kept": all(tp_of(a) == tp_of(b) for (_, a), (_, b) in pairs),
        "q_split": tp_of(restored["enc"]["layers"][0]["attn"]["q"]["w"]) is not None,
    }
    if rank == 0:
        one = load_params(inp["tmp"] + "/params", params_from_numpy(inp["ckpt_params"], ckpt_cfg, device="cpu"))
        out["ckpt"]["one_device_equal"] = all(torch.equal(a, b) for a, b in zip(one.parameters(), full.parameters()))
    dist.barrier()
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def jax_side():
    import jax

    from streamkit_tpu.models.whisper.config import WhisperConfig as JaxWhisperConfig
    from streamkit_tpu.models.whisper.model import init_params

    from streamkit_tpu.models.marian import MarianConfig as JaxMarianConfig
    from streamkit_tpu.models.marian import marian_init_params as jmarian
    from streamkit_tpu.models.nllb import NllbConfig as JaxNllbConfig
    from streamkit_tpu.models.nllb import nllb_init_params as jnllb

    def tree(dims, seed):
        return affine_random(
            jax.tree.map(np.asarray, init_params(JaxWhisperConfig(**dims), jax.random.PRNGKey(seed))), seed)

    nllb = jax.tree.map(np.asarray, jnllb(JaxNllbConfig(**SEQ2SEQ_DIMS), seed=0))
    marian = jax.tree.map(np.asarray, jmarian(JaxMarianConfig(**SEQ2SEQ_DIMS, **MARIAN_IDS), seed=0))

    rng = np.random.RandomState(0)
    mel = rng.randn(4, TINY.n_audio_ctx * 2, TINY.n_mels).astype(np.float32) * 0.3
    tokens = rng.randint(0, TINY.n_vocab, (4, 8)).astype(np.int32)
    rng = np.random.RandomState(1)
    train_batch = (rng.randn(8, TINY.n_audio_ctx * 2, TINY.n_mels).astype(np.float32) * 0.3,
                   np.full((8, 8), 5, np.int32), np.full((8, 8), 7, np.int32), np.ones((8, 8), np.float32))
    src = np.random.RandomState(5).randint(4, 128, size=(4, 9)).astype(np.int32)
    return {"fwd_params": tree(DIMS, 1), "fwd_inputs": (mel, tokens), "odd_params": tree(ODD_DIMS, 0),
            "train_params": tree(DIMS, 2), "train_batch": train_batch, "nllb_src": src,
            "nllb_params": affine_random(nllb, 6), "marian_params": affine_random(marian, 7),
            "ckpt_params": tree(CKPT_DIMS, 1)}


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    inp = dict(jax_side, tmp=str(tmp_path_factory.mktemp("mesh")))
    return run_ranks(_scenarios, WORLD, inp, device="cpu", timeout_s=DEADLINE_S)[0]


def test_mesh_shapes(port):
    from streamkit_tpu.parallel import make_mesh as jax_make_mesh

    jmesh = jax_make_mesh(8, tp=2)
    assert port["mesh"] == (jmesh.devices.shape, tuple(jmesh.axis_names)) == ((4, 2), ("dp", "tp"))
    assert "not divisible" in port["tp3"]
    with pytest.raises(ValueError):
        jax_make_mesh(8, tp=3)


def _jax_specs(dims, params_np):
    import jax
    from jax.sharding import PartitionSpec as P

    from streamkit_tpu.parallel import make_mesh as jax_make_mesh
    from streamkit_tpu.parallel import whisper_param_sharding as jax_sharding

    shardings = jax_sharding(jax_make_mesh(8, tp=2), params_np)
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    names = {P(): "Replicate()", P(None, "tp"): "Shard(1)", P("tp", None): "Shard(0)", P("tp"): "Shard(0)",
             P(None, None, "tp"): "Shard(2)"}
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): names[s.spec]
            for path, s in flat}


@pytest.mark.parametrize("case", ["tiny", "odd_heads"])
def test_param_sharding_layout(port, jax_side, case):
    """Leaf by leaf against the reference's specs. The two stated differences
    are the only ones: the encoder convolutions stay replicated, and an
    attention block whose heads do not divide by tp stays whole."""
    params = jax_side["fwd_params"] if case == "tiny" else jax_side["odd_params"]
    want = _jax_specs(DIMS if case == "tiny" else ODD_DIMS, params)
    got = port["layout"][case]
    assert set(got) == set(want)
    differ = {k for k in want if got[k] != want[k]}
    convs = {k for k in want if ".conv" in k and want[k] != "Replicate()"}
    heads = {k for k in want if (".attn." in k or ".xattn." in k) and want[k] != "Replicate()"}
    assert differ == (convs | heads if case == "odd_heads" else convs), sorted(differ)
    assert all(got[k] == "Replicate()" for k in differ)
    if case == "tiny":  # the reference test's own four leaves
        assert got["enc.layers.0.attn.q.w"] == "Shard(1)"
        assert got["enc.layers.0.attn.o.w"] == "Shard(0)"
        assert got["dec.tok_emb"] == "Shard(0)"
        assert got["enc.ln_post.g"] == "Replicate()"


def test_sharded_forward_matches_single_device(port, jax_side):
    """TP-sharded forward (dp 4 × tp 2) against the JAX single-device forward
    (the JAX test's atol) and the port's one-rank forward (1e-5)."""
    import jax

    from streamkit_tpu.models.whisper.config import WhisperConfig as JaxWhisperConfig
    from streamkit_tpu.models.whisper.model import decode_logits as jdecode, encode as jencode

    jcfg = JaxWhisperConfig(**DIMS)
    mel, tokens = jax_side["fwd_inputs"]
    params = jax.tree.map(jax.numpy.asarray, jax_side["fwd_params"])
    ref = np.asarray(jax.jit(lambda p, m, t: jdecode(p, jcfg, t, jencode(p, jcfg, m)))(params, mel, tokens))
    got, one = port["forward"]
    assert port["q_local_shape"] == (64, 32)  # a column block of q
    np.testing.assert_allclose(got, ref, atol=3e-4)
    np.testing.assert_allclose(got, one, atol=1e-5, rtol=0)


def test_sharded_train_step_runs_and_descends(port):
    train = port["train"]
    assert train["losses"][-1] < train["losses"][0], train["losses"]
    assert train["step"] == 5


def test_sharded_train_step_matches_one_rank(port):
    """The first sharded step against the port's one-rank step on the whole
    batch: the loss and every gradient within 1e-5, and every parameter
    whose gradient exceeds 1e-5 within 1e-5. The elements with a smaller
    gradient (AdamW's first step there depends on the last bits of g) stay
    within the step's bound, lr, and their AdamW moments, which are linear
    in g and g², within 1e-5 of the one-rank moments in units of g."""
    train = port["train"]
    assert abs(train["losses"][0] - train["one_rank_loss"]) <= 1e-5, train
    assert train["grad_gap"] <= 1e-5, train["grad_gap"]
    assert train["param_gap"] <= 1e-5, train["param_gap"]
    assert train["steep_gap"] <= LR, train["steep_gap"]
    assert train["moment_gap"] <= 1e-5, train["moment_gap"]


def test_sharded_train_state_checkpoint_loads_on_one_device(port):
    train = port["train"]
    assert train["ckpt_step"] == 1
    assert train["ckpt_param_gap"] == 0.0
    assert train["ckpt_moment_gap"] <= 1e-5, train["ckpt_moment_gap"]


def test_seq2seq_tp_sharded_decode_matches_single_device(port, jax_side):
    """NLLB cached greedy at tp = 2: tokens and lengths equal to the JAX
    single-device decode and to the port's one-rank decode."""
    import jax

    from streamkit_tpu.models.nllb import NllbConfig as JaxNllbConfig
    from streamkit_tpu.models.nllb import nllb_greedy_cached as jgreedy

    jcfg = JaxNllbConfig(**SEQ2SEQ_DIMS)
    ref_toks, ref_lens = jax.jit(lambda p, s: jgreedy(p, jcfg, s, 5, max_tokens=8))(
        jax_side["nllb_params"], jax_side["nllb_src"])
    assert port["nllb_layout"] == {"dec_layers.0.attn.q.w": "Shard(1)", "dec_layers.0.attn.o.w": "Shard(0)",
                                   "emb": "Shard(0)", "enc_ln.g": "Replicate()"}
    toks, lens = port["nllb"]
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))
    np.testing.assert_array_equal(toks, port["nllb_one"][0])
    np.testing.assert_array_equal(lens, port["nllb_one"][1])


def test_marian_tp_sharded_decode_matches_single_device(port, jax_side):
    """Marian cached greedy at tp = 2, its ``logits_bias`` split with the
    vocabulary: tokens and lengths equal to the JAX single-device decode and
    to the port's one-rank decode."""
    import jax

    from streamkit_tpu.models.marian import MarianConfig as JaxMarianConfig
    from streamkit_tpu.models.marian import marian_greedy_cached as jgreedy

    jcfg = JaxMarianConfig(**SEQ2SEQ_DIMS, **MARIAN_IDS)
    ref_toks, ref_lens = jax.jit(lambda p, s: jgreedy(p, jcfg, s, max_tokens=8))(
        jax_side["marian_params"], jax_side["nllb_src"])
    assert port["marian_layout"] == "Shard(0)"
    toks, lens = port["marian"]
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))
    np.testing.assert_array_equal(toks, port["marian_one"][0])
    np.testing.assert_array_equal(lens, port["marian_one"][1])


def test_sharded_params_roundtrip(port):
    """The reference's test_sharded_params_roundtrip: save on the mesh, load
    into the sharded template: bit for bit, placements kept; and the mesh's
    checkpoint loads on one device as the whole tree."""
    ckpt = port["ckpt"]
    assert ckpt == {"bit_equal": True, "placements_kept": True, "q_split": True, "one_device_equal": True}


def test_dryrun_multichip_on_cpu_ranks():
    """The counterpart of __graft_entry__.dryrun_multichip(8): a sharded
    train step, sharded inference and two fused blocks through a real
    batcher on the sharded int8 table, on 8 gloo ranks (dp 4 × tp 2)."""
    ranks = dryrun_multichip(8, device="cpu", timeout_s=DEADLINE_S)
    assert len(ranks) == 8
    assert {(r["dp"], r["tp"]) for r in ranks} == {(4, 2)}
    assert len({r["loss"] for r in ranks}) == 1 and np.isfinite(ranks[0]["loss"])
    assert ranks[0]["enc_pos"] == [8] * 4 and min(ranks[0]["n_tok"]) >= 4
