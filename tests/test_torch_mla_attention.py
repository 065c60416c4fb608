"""The port's absorbed-MLA decode attention (plain PyTorch path, as the
wrapper runs it for a CPU tensor) against the JAX oracle ``ref.py`` and the
JAX Pallas kernel in interpret mode, on the same seeded numpy inputs.

Tolerance: rtol = atol = 3e-5, the repository's kernel-test tolerance
(float32 on both sides, a different summation order). The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mla_attention.ops import mla_decode_attention as jax_kernel
from repro.kernels.mla_attention.ref import mla_decode_attention_ref as jax_ref
from repro_torch.kernels.mla_attention import ops
from repro_torch.kernels.mla_attention.ref import mla_decode_attention_ref

TOL = 3e-5
SCALE = 0.125


def _inputs(b, h, r, dr, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, r).astype(np.float32),
            rng.randn(b, h, dr).astype(np.float32),
            rng.randn(b, s, r + dr).astype(np.float32))


def _port(ql, qr, cache, cache_len):
    return ops.mla_decode_attention(
        torch.from_numpy(ql), torch.from_numpy(qr), torch.from_numpy(cache),
        torch.from_numpy(np.asarray(cache_len, np.int32)), SCALE).numpy()


# The shapes of tests/test_kernels.py's MLA sweep.
@pytest.mark.parametrize("b,h,r,dr,s", [(1, 4, 32, 16, 64), (2, 8, 64, 16, 256),
                                        (2, 16, 128, 64, 128)])
@pytest.mark.parametrize("valid_len", [1, 37, None])
def test_plain_matches_jax_ref_and_interpret_kernel(b, h, r, dr, s, valid_len):
    ql, qr, cache = _inputs(b, h, r, dr, s, seed=b * s + h)
    vl = s if valid_len is None else min(valid_len, s)
    valid = jnp.arange(s) < vl
    # JAX's shared `valid` of vl positions is cache_len = vl - 1 per row
    # (the port's rows attend to positions 0..cache_len inclusive).
    got = _port(ql, qr, cache, [vl - 1] * b)
    want_ref = np.asarray(jax_ref(jnp.asarray(ql), jnp.asarray(qr),
                                  jnp.asarray(cache), valid, SCALE, r))
    want_kernel = np.asarray(jax_kernel(jnp.asarray(ql), jnp.asarray(qr),
                                        jnp.asarray(cache), valid, SCALE, r))
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_kernel, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,lens", [(64, [0, 5, 63, 64]),
                                    (256, [255, 0, 128, 1]),
                                    (100, [99, 100, 37, 50])])
def test_ragged_per_row_cache_len(s, lens):
    """Per-row lengths (which the Pallas kernel cannot take) against the
    JAX oracle and interpret kernel run row by row; a row at cache_len == S
    (a capacity-frozen slot) attends to the whole cache."""
    b, h, r, dr = len(lens), 8, 64, 16
    ql, qr, cache = _inputs(b, h, r, dr, s, seed=s)
    got = _port(ql, qr, cache, lens)
    for i, cl in enumerate(lens):
        valid = jnp.arange(s) <= min(cl, s - 1)
        args = (jnp.asarray(ql[i:i + 1]), jnp.asarray(qr[i:i + 1]),
                jnp.asarray(cache[i:i + 1]), valid, SCALE, r)
        np.testing.assert_allclose(got[i:i + 1], np.asarray(jax_ref(*args)),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[i:i + 1], np.asarray(jax_kernel(*args)),
                                   rtol=TOL, atol=TOL)


def test_cpu_tensor_takes_plain_path_without_launch():
    ql, qr, cache = _inputs(2, 16, 128, 64, 96, seed=3)
    before = ops.LAUNCHES
    got = _port(ql, qr, cache, [10, 95])
    assert ops.LAUNCHES == before
    want = mla_decode_attention_ref(
        torch.from_numpy(ql), torch.from_numpy(qr), torch.from_numpy(cache),
        torch.tensor([10, 95], dtype=torch.int32), SCALE).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "len_dtype",
                                 "len_shape", "width", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q_lat = torch.zeros(2, 16, 32)
    q_rope = torch.zeros(2, 16, 16)
    cache = torch.zeros(2, 8, 48)
    cache_len = torch.zeros(2, dtype=torch.int32)
    if bad == "dtype":
        q_lat = q_lat.double()
    elif bad == "contiguous":
        cache = torch.zeros(2, 48, 8).transpose(1, 2)
    elif bad == "len_dtype":
        cache_len = cache_len.long()
    elif bad == "len_shape":
        cache_len = torch.zeros(3, dtype=torch.int32)
    elif bad == "width":
        cache = torch.zeros(2, 8, 40)
    else:  # a device that is neither the CPU nor CUDA has no path at all
        q_lat, q_rope, cache, cache_len = (
            t.to("meta") for t in (q_lat, q_rope, cache, cache_len))
    with pytest.raises(ValueError):
        ops.mla_decode_attention(q_lat, q_rope, cache, cache_len, SCALE)


@pytest.mark.parametrize("b,h,s,n_sm,want", [
    (8, 128, 2048, 132, 13),     # R1 decode batch: ~6 blocks per SM
    (32, 128, 2048, 132, 4),     # a wider batch needs fewer pieces
    (1, 16, 100_000, 132, 64),   # capped at MAX_SPLIT
    (8, 128, 40, 132, 2),        # no more pieces than 32-position tiles
])
def test_split_count(b, h, s, n_sm, want):
    assert ops.n_split_for(b, h, s, n_sm) == want
