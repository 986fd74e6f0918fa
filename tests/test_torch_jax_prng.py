# SPDX-License-Identifier: Apache-2.0
"""The port's threefry draws (``utils/jax_prng.py``) against ``jax.random``
on the CPU: keys, bits, uniforms and normals equal bit for bit, and the
Kokoro random init that goes through them equal leaf by leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamkit_tpu_torch.utils import jax_prng

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

SHAPES = [(7,), (178, 512), (5, 512, 512), (1, 256, 80)]


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_keys_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(jax_prng.PRNGKey(seed), np.asarray(key))
    for num in (2, 3, 24):
        assert np.array_equal(jax_prng.split(jax_prng.PRNGKey(seed), num), np.asarray(jax.random.split(key, num)))
    # a split of a split: the key tree Kokoro's init walks
    sub = jax.random.split(jax.random.split(key, 24)[5])
    assert np.array_equal(jax_prng.split(jax_prng.split(jax_prng.PRNGKey(seed), 24)[5]), np.asarray(sub))


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bits_uniform_and_normal_equal_jax(seed, shape):
    """32-bit bits, uniforms on [0, 1) and on [-3.3, 7.1), and normals: all
    equal to ``jax.random``'s bit for bit (no ulp of difference)."""
    key = jax.random.PRNGKey(seed)
    mine = jax_prng.PRNGKey(seed)
    assert np.array_equal(jax_prng.random_bits(mine, shape), np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    assert np.array_equal(jax_prng.uniform(mine, shape), np.asarray(jax.random.uniform(key, shape)))
    got = jax_prng.uniform(mine, shape, -3.3, 7.1)
    assert np.array_equal(got, np.asarray(jax.random.uniform(key, shape, minval=-3.3, maxval=7.1)))
    got, want = jax_prng.normal(mine, shape), np.asarray(jax.random.normal(key, shape))
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))


def test_erf_inv_equals_xla_over_its_range():
    """Every branch of the erfinv evaluation (both log1p branches, both
    polynomials, values next to ±1) against ``lax.erf_inv``."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.concatenate([
        np.linspace(lo, -lo, 200001, dtype=np.float32),
        np.asarray([lo, -lo, 0.0, 1e-30, -1e-7, 0.6435942, -0.6435942], np.float32),
        np.random.RandomState(0).uniform(-1, 1, 100000).astype(np.float32),
    ])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    assert np.array_equal(jax_prng.erf_inv(x), want)
    with pytest.raises(ValueError):
        jax_prng.erf_inv(np.asarray([1.0], np.float32))


def test_kokoro_random_init_equals_jax_leaf_by_leaf():
    """``kokoro_init_params`` at the golden pack's width (hidden 512, 32
    tokens) from ``PRNGKey(0)`` and from ``PRNGKey(7)``: every leaf equal,
    convolution weights in PyTorch's layout."""
    from streamkit_tpu.models import kokoro as jk
    from streamkit_tpu_torch.models import kokoro as tk

    cfg_j, cfg_t = jk.KokoroConfig(n_tokens=32), tk.KokoroConfig(n_tokens=32)
    for seed in (0, 7):
        want = jk.kokoro_init_params(cfg_j, jax.random.PRNGKey(seed))
        got = tk.kokoro_init_params(cfg_t, jax_prng.PRNGKey(seed), device="cpu")
        paths_w = jax.tree_util.tree_flatten_with_path(want)[0]
        paths_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(paths_w) == len(paths_g) == 41
        for path, w in paths_w:
            w = np.asarray(w)
            g = paths_g[path].numpy()
            assert np.array_equal(w.transpose(2, 1, 0) if w.ndim == 3 else w, g), path
