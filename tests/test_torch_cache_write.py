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


def test_supports_states_the_kernels_own_limits():
    """No 128-lane rule: any ring at least as wide as the window."""
    assert tcw.supports(512, 16) and tcw.supports(64, 3) and tcw.supports(264, 16) and tcw.supports(16, 16)
    assert not tcw.supports(8, 16) and not tcw.supports(512, 0)
