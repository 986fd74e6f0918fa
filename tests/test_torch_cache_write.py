# SPDX-License-Identifier: Apache-2.0
"""Kernel K2 (windowed ring write into the streaming caches): the port's
plain version against the JAX package's Pallas kernels in interpret mode,
bit-exact, at the reference tests' parameter sets, and the wrapper's CPU
routing. The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamkit_tpu.ops import cache_write as jcw
from streamkit_tpu_torch.ops import cache_write as tcw

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others


def _inputs(shape_cache, c, dtype, seed=0):
    rng = np.random.RandomState(seed)
    shape_upd = shape_cache[:-1] + (c,)
    if dtype == np.int8:
        return (rng.randint(-127, 128, shape_cache).astype(dtype),
                rng.randint(-127, 128, shape_upd).astype(dtype), rng)
    return rng.randn(*shape_cache).astype(dtype), rng.randn(*shape_upd).astype(dtype), rng


@pytest.mark.parametrize(
    "S,F,T,c,dtype",
    [
        (4, 256, 512, 16, np.int8),  # enc-cache shape class (int8 KV)
        (3, 128, 256, 16, np.float32),  # scale-cache class
        (2, 128, 128, 8, np.int8),  # single-column-block ring
        (2, 64, 64, 16, np.float32),  # sub-lane T (tiny test configs)
    ],
)
def test_windowed_write_matches_jax(S, F, T, c, dtype):
    cache, upd, rng = _inputs((S, F, T), c, dtype)
    pos = (rng.randint(0, T // 8, (S,)) * 8).astype(np.int32)
    pos[0] = T - 8  # wrap-around
    lim = rng.randint(0, c + 1, (S,)).astype(np.int32)
    lim[S - 1] = 0  # inert row
    want = np.asarray(jcw.windowed_write(jnp.asarray(cache), jnp.asarray(upd), jnp.asarray(pos),
                                         jnp.asarray(lim), interpret=True, fb=64))
    got = torch.from_numpy(cache.copy())
    out = tcw.windowed_write(got, torch.from_numpy(upd), torch.from_numpy(pos), torch.from_numpy(lim))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "G,S,F,T,c,dtype,gb",
    [
        (4, 3, 256, 512, 16, np.int8, 0),  # layer-major enc-cache class
        (4, 2, 64, 512, 16, np.float32, 2),  # explicit group blocking (reference side)
        (3, 2, 128, 128, 8, np.int8, 0),
        (2, 2, 64, 64, 16, np.float32, 0),  # sub-lane T
    ],
)
def test_windowed_write_groups_matches_jax(G, S, F, T, c, dtype, gb):
    cache, upd, rng = _inputs((G, S, F, T), c, dtype)
    pos = (rng.randint(0, max(T // 8, 1), (S,)) * 8 % T).astype(np.int32)
    pos[0] = T - 8
    lim = rng.randint(0, c + 1, (S,)).astype(np.int32)
    lim[S - 1] = 0
    want = np.asarray(jcw.windowed_write_groups(jnp.asarray(cache), jnp.asarray(upd), jnp.asarray(pos),
                                                jnp.asarray(lim), interpret=True, gb=gb))
    got = torch.from_numpy(cache.copy())
    tcw.windowed_write_groups(got, torch.from_numpy(upd), torch.from_numpy(pos), torch.from_numpy(lim))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_write_is_bitwise():
    """bf16 (the decoder folds' dtype) round-trips bit for bit, wrapping row
    included, against the reference kernel."""
    rng = np.random.RandomState(1)
    cache = rng.randn(3, 2, 64, 64).astype(np.float32)
    upd = rng.randn(3, 2, 64, 3).astype(np.float32)
    pos, lim = np.asarray([62, 5], np.int32), np.asarray([3, 2], np.int32)
    want = jcw.windowed_write_groups(jnp.asarray(cache, jnp.bfloat16), jnp.asarray(upd, jnp.bfloat16),
                                     jnp.asarray(pos), jnp.asarray(lim), interpret=True)
    got = torch.from_numpy(cache).bfloat16()
    tcw.windowed_write_groups(got, torch.from_numpy(upd).bfloat16(), torch.from_numpy(pos), torch.from_numpy(lim))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_wrapper_routes_cpu_tensors_to_plain_version():
    cache, upd, _ = _inputs((2, 3, 8, 32), 8, np.float32)
    pos, lim = torch.tensor([30, 0, 8]), torch.tensor([8, 0, 5])
    before = tcw.windowed_write_groups.launches
    got = tcw.windowed_write_groups(torch.from_numpy(cache.copy()), torch.from_numpy(upd), pos, lim)
    want = tcw.windowed_write_reference(torch.from_numpy(cache.copy()), torch.from_numpy(upd), pos, lim)
    assert tcw.windowed_write_groups.launches == before
    assert torch.equal(got, want)
    assert torch.equal(got[:, 1], torch.from_numpy(cache[:, 1]))  # lim = 0 row untouched
    with pytest.raises(ValueError, match="CUDA"):
        tcw._check(got, torch.from_numpy(upd))


def _pair(G, S, F, T, c, dtype, rng):
    if dtype == np.int8:
        return (rng.randint(-127, 128, (G, S, F, T)).astype(dtype),
                rng.randint(-127, 128, (G, S, F, c)).astype(dtype))
    return rng.randn(G, S, F, T).astype(np.float32), rng.randn(G, S, F, c).astype(np.float32)


def _torch(x, dtype):
    t = torch.from_numpy(x.copy())
    return t.bfloat16() if dtype == "bf16" else t


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16) if dtype == "bf16" else jnp.asarray(x)


# (G, F, T, c, dtype) per pair, and the positions' kind: the fused step's
# encoder write (4 int8 caches and their f32 scales, starts at multiples of
# 8), its decoder folds (bf16, 3 columns at any start) and a mixed batch
_ENC = [(2, 256, 512, 16, np.int8), (2, 4, 512, 16, np.float32)] * 4
_FOLD = [(2, 64, 64, 3, "bf16")] * 2
_MIXED = [(2, 16, 128, 8, np.int8), (1, 8, 64, 8, np.float32), (3, 32, 256, 12, "bf16"), (2, 5, 40, 7, np.float32)]


@pytest.mark.parametrize("specs,chunked", [(_ENC, True), (_FOLD, False), (_MIXED, False)],
                         ids=["encoder-8-pairs", "fold-pair", "mixed-dtypes"])
def test_windowed_write_many_matches_jax(specs, chunked):
    """One call over every pair equals JAX's windowed_write_groups (interpret
    mode) applied pair by pair, bit for bit: a wrapping row, a lim = 0 row
    and a lim > c row among random ones. JAX's kernel writes zeros past c
    when lim > c (no caller passes that); the port counts it as c, so the
    reference side gets min(lim, c)."""
    S = 5
    rng = np.random.RandomState(3)
    T_min = min(s[2] for s in specs)
    pos = (rng.randint(0, T_min // 8, S) * 8 if chunked else rng.randint(0, T_min, S)).astype(np.int32)
    c_max = max(s[3] for s in specs)
    lim = rng.randint(1, c_max + 1, S).astype(np.int32)
    pos[0], lim[0] = T_min - (8 if chunked else 2), c_max  # wraps in the narrowest ring
    lim[1] = 0
    lim[2] = c_max + 5
    arrays = [(_pair(G, S, F, T, c, np.int8 if dt is np.int8 else np.float32, rng), dt) for G, F, T, c, dt in specs]
    got = [(_torch(cache, dt), _torch(upd, dt)) for (cache, upd), dt in arrays]
    before = tcw.windowed_write_groups.launches
    tcw.windowed_write_many(got, torch.from_numpy(pos), torch.from_numpy(lim))
    assert tcw.windowed_write_groups.launches == before
    for ((cache, upd), dt), (t_cache, _), spec in zip(arrays, got, specs):
        want = np.asarray(jcw.windowed_write_groups(_jax(cache, dt), _jax(upd, dt), jnp.asarray(pos),
                                                    jnp.asarray(np.minimum(lim, spec[3])), interpret=True))
        if dt == "bf16":
            np.testing.assert_array_equal(t_cache.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t_cache.numpy(), want)
        np.testing.assert_array_equal(t_cache[:, 1].float().numpy(), _torch(cache, dt)[:, 1].float().numpy())


def _refusal_cases():
    z = torch.zeros
    ok = (z(2, 3, 4, 16), z(2, 3, 4, 8))
    pos3, lim3 = torch.zeros(3, dtype=torch.int32), torch.full((3,), 8, dtype=torch.int32)
    meta = (z(2, 3, 4, 16, device="meta"), z(2, 3, 4, 8, device="meta"))
    return {
        "mismatched-S": ([ok, (z(2, 4, 4, 16), z(2, 4, 4, 8))], pos3, lim3, "S = 3"),
        "pos-shape": ([ok], torch.zeros(4, dtype=torch.int32), lim3, r"pos and lim must be \[3\]"),
        "lim-shape": ([ok], pos3, torch.zeros(3, 1, dtype=torch.int32), r"pos and lim must be \[3\]"),
        "non-contiguous-upd": ([(ok[0], z(2, 3, 4, 16)[..., ::2])], pos3, lim3, "contiguous"),
        "nine-pairs": ([ok] * 9, pos3, lim3, "1 to 8"),
        "no-pairs": ([], pos3, lim3, "1 to 8"),
        "dtype-mix-in-a-pair": ([(ok[0], ok[1].double())], pos3, lim3, "dtype"),
        "window-wider-than-ring": ([(z(2, 3, 4, 8), z(2, 3, 4, 16))], pos3, lim3, "unsupported"),
        "cpu-and-other-device": ([ok, meta], pos3, lim3, "one device"),
        "cache-and-upd-apart": ([(ok[0], meta[1])], pos3, lim3, "one device"),
        "not-cpu-not-cuda": ([meta], pos3, lim3, "CUDA"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_windowed_write_many_refuses(case):
    """Every refusal is raised before anything is written, on any device:
    the CPU route checks what the kernel would refuse."""
    pairs, pos, lim, match = _refusal_cases()[case]
    with pytest.raises(ValueError, match=match):
        tcw.windowed_write_many(pairs, pos, lim)
    for cache, _ in pairs:
        if cache.device.type == "cpu":
            assert not cache.any()


def test_groups_is_the_one_pair_case_of_many():
    """windowed_write_groups and windowed_write_many over one pair write the
    same cache, with pos outside [0, T) and lim > c."""
    cache, upd, _ = _inputs((3, 4, 8, 32), 8, np.float32, seed=5)
    pos, lim = torch.tensor([-3, 31, 64, 70]), torch.tensor([8, 12, 3, 0])
    a, b = torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())
    tcw.windowed_write_groups(a, torch.from_numpy(upd), pos, lim)
    tcw.windowed_write_many([(b, torch.from_numpy(upd))], pos, lim)
    want = tcw.windowed_write_reference(torch.from_numpy(cache.copy()), torch.from_numpy(upd), pos, lim)
    assert torch.equal(a, want) and torch.equal(b, want)
    assert torch.equal(a[:, 0, :, 29:32], torch.from_numpy(upd[:, 0, :, :3]))  # -3 wraps to 29
    assert torch.equal(a[:, 0, :, :5], torch.from_numpy(upd[:, 0, :, 3:8]))


def test_supports_states_the_kernels_own_limits():
    """No 128-lane rule: any ring at least as wide as the window."""
    assert tcw.supports(512, 16) and tcw.supports(64, 3) and tcw.supports(264, 16) and tcw.supports(16, 16)
    assert not tcw.supports(8, 16) and not tcw.supports(512, 0)
