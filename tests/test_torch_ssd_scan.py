"""The port's SSD chunked scan (plain PyTorch path, as the wrapper runs it
for a CPU tensor) against the JAX package's ``ssd_scan`` (the Pallas kernel
in interpret mode), its oracle ``ssd_scan_ref`` and its ``ssd_chunked``, on
the same seeded numpy inputs.

Tolerances:
- against the kernel and the oracle, rtol = atol = 2e-4, the repository's
  own (``tests/test_kernels.py:79-80``): float32 through a quadratic form
  and exponentials, summed in another order than the token recurrence;
- against ``ssd_chunked`` at a chunk that divides S, 1e-5
  (``test_kernels.py:94-95``): the same decomposition, in another order;
- at lengths the chunk does not divide, the port's ragged last chunk
  against JAX's halved chunks (down to 1-row chunks for odd S), 1e-5
  rtol/atol: both are exact decompositions in float32, so they differ by
  summation order only, as at equal chunks.
The plain version is written as the kernel's stages (C.B^T, cum and the
chunk states, state passing, output); each stage is held here against a
direct formula in float64 (1e-10: the same sums in another order), and the
wrapper's scratch shapes against the stages' shapes. The CUDA kernel itself is
held against the same plain version, stage by stage, on the card by
``chip_smoke.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_kernel
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ref
from repro.models import mamba2 as j_mamba
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import mamba2 as t_mamba

KERNEL_TOL = 2e-4
CHUNKED_TOL = 1e-5

J_CHUNKED = jax.jit(j_mamba.ssd_chunked, static_argnames=("chunk",))


def _inputs(b, s, h, p, n, seed):
    """As ``test_kernels.py`` draws them: dt in [0.001, 0.1), a_log ~
    0.1 N(0, 1)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, p).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32),
            (0.1 * rng.randn(h)).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


# The shapes of tests/test_kernels.py's SSD sweep; then a ragged S (JAX
# falls to 1-row chunks), S < Q, S = 1, B = 2, and P and N off every tile.
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 96, 2, 64, 128, 32),
    (1, 45, 2, 8, 8, 16), (1, 12, 2, 8, 8, 32), (1, 1, 2, 8, 8, 16),
    (2, 48, 3, 8, 16, 16), (1, 40, 2, 5, 12, 16),
])
def test_plain_matches_jax_kernel_and_ref(b, s, h, p, n, chunk):
    """The composed stages against the Pallas kernel and the oracle at
    KERNEL_TOL, and against JAX's ``ssd_chunked`` at CHUNKED_TOL."""
    args = _inputs(b, s, h, p, n, seed=s + h)
    y, hf = ops.ssd_scan(*_t(*args), chunk=chunk)
    for want_y, want_h in (jax_kernel(*args, chunk=chunk), jax_ref(*args)):
        _close(y, want_y, KERNEL_TOL)
        _close(hf, want_h, KERNEL_TOL)
    want_y, want_h = J_CHUNKED(*args, chunk=chunk)
    _close(y, want_y, CHUNKED_TOL)
    _close(hf, want_h, CHUNKED_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
])
def test_chunked_matches_jax_chunked_where_the_chunk_divides(b, s, h, p, n,
                                                             chunk):
    args = _inputs(b, s, h, p, n, seed=9)
    y, hf = t_mamba.ssd_chunked(*_t(*args), chunk=chunk)
    want_y, want_h = J_CHUNKED(*args, chunk=chunk)
    _close(y, want_y, CHUNKED_TOL)
    _close(hf, want_h, CHUNKED_TOL)


def test_chunked_computes_in_the_dtype_of_its_inputs():
    """float64 inputs give a float64 evaluation (the accuracy reference the
    card's check measures both f32 forms against)."""
    args = _t(*_inputs(1, 37, 3, 16, 8, seed=4))
    y, hf = t_mamba.ssd_chunked(*args, chunk=16)
    y64, hf64 = t_mamba.ssd_chunked(*(a.double() for a in args), chunk=16)
    assert y64.dtype == hf64.dtype == torch.float64
    _close(y, y64.numpy(), CHUNKED_TOL)
    _close(hf, hf64.numpy(), CHUNKED_TOL)


@pytest.mark.parametrize("s", [1, 5, 31, 37, 97])
def test_ragged_last_chunk_matches_jax_halved_chunks(s):
    """S % 32 != 0: the port runs chunks of 32 with a ragged tail where JAX
    falls to chunks of 1 (37, 97, 31, 5) -- the same function either way."""
    args = _inputs(2, s, 3, 16, 8, seed=s)
    y, hf = ops.ssd_scan(*_t(*args), chunk=32)
    want_y, want_h = J_CHUNKED(*args, chunk=32)
    _close(y, want_y, CHUNKED_TOL)
    _close(hf, want_h, CHUNKED_TOL)
    # ... and the naive recurrence, on both sides.
    ry, rh = t_mamba.ssd_reference(*_t(*args))
    jy, jh = j_mamba.ssd_reference(*args)
    _close(ry, jy, CHUNKED_TOL)
    _close(rh, jh, CHUNKED_TOL)
    _close(y, jy, KERNEL_TOL)
    _close(hf, jh, KERNEL_TOL)


def test_large_decay_stays_finite():
    """A steep decay (cum far below 0) must not reach exp of a large
    positive difference above the diagonal: no inf, no NaN."""
    x, dt, a_log, bm, cm = _inputs(1, 64, 2, 8, 8, seed=3)
    dt = dt * 400.0                      # cum falls to about -2000 per chunk
    y, hf = ops.ssd_scan(*_t(x, dt, a_log, bm, cm), chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    ry, rh = t_mamba.ssd_reference(*_t(x, dt, a_log, bm, cm))
    _close(y, ry, KERNEL_TOL)
    _close(hf, rh, KERNEL_TOL)


def test_empty_sequence_gives_zero_state():
    x, dt, a_log, bm, cm = _t(*_inputs(2, 0, 3, 4, 8, seed=0))
    y, hf = ops.ssd_scan(x, dt, a_log, bm, cm)
    assert tuple(y.shape) == (2, 0, 3, 4) and tuple(hf.shape) == (2, 3, 4, 8)
    assert not hf.any()


class _Elsewhere(torch.Tensor):
    """A tensor whose metadata says it lives on an XPU, a device that is
    neither the CPU, CUDA nor meta; ops run on its shape alone."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, strides=t.stride(), dtype=t.dtype,
            device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        """Runs ``func`` on meta stand-ins: shapes and strides only."""
        from torch.utils._pytree import tree_map

        def meta(t):
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device="meta") \
                if isinstance(t, cls) else t

        out = func(*tree_map(meta, args), **tree_map(meta, kwargs or {}))
        return tree_map(lambda t: cls(t) if isinstance(t, torch.Tensor)
                        else t, out)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "dt_shape",
                                 "a_shape", "bc_shape", "chunk", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, dt, a_log, bm, cm = _t(*_inputs(2, 8, 3, 4, 8, seed=1))
    chunk = 4
    if bad == "dtype":
        x = x.double()
    elif bad == "contiguous":
        bm = torch.zeros(2, 8, 8).transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "dt_shape":
        dt = dt[:, :7]
    elif bad == "a_shape":
        a_log = torch.zeros(4)
    elif bad == "bc_shape":
        cm = torch.zeros(2, 8, 9)
    elif bad == "chunk":
        chunk = 0
    else:  # a device other than the CPU, CUDA and meta has no path
        x, dt, a_log, bm, cm = (_Elsewhere(t) for t in (x, dt, a_log, bm, cm))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, a_log, bm, cm, chunk=chunk)


def _direct_stages(x, dt, a_log, bm, cm, q):
    """Every stage of the chunked scan by its defining sums, in float64
    numpy loops: cum (b,nc,h,q), C.B^T (b,nc,q,q), chunk states and the
    states entering each chunk (b,nc,h,p,n), the final state, y (b,S,h,p).
    The entering state is summed over earlier chunks' states, each decayed
    by the chunks between -- not by the recurrence the code runs."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    nc = -(-s // q)
    a = -np.exp(a_log)
    rows = [range(c * q, min(c * q + q, s)) for c in range(nc)]
    cum = np.zeros((b, nc, h, q))
    cb = np.zeros((b, nc, q, q))
    st = np.zeros((b, nc, h, p, n))
    for bi in range(b):
        for c, rs in enumerate(rows):
            for i, t in enumerate(rs):
                cum[bi, c, :, i] = sum(dt[bi, r] * a for r in rs[:i + 1])
                for j, r in enumerate(rs):
                    cb[bi, c, i, j] = cm[bi, t] @ bm[bi, r]
            cum[bi, c, :, len(rs):] = cum[bi, c, :, len(rs) - 1:len(rs)]
            for hi in range(h):
                for i, t in enumerate(rs):
                    st[bi, c, hi] += (np.exp(cum[bi, c, hi, -1]
                                             - cum[bi, c, hi, i])
                                      * dt[bi, t, hi]
                                      * np.outer(x[bi, t, hi], bm[bi, t]))
    decay = np.exp(cum[..., -1])                       # (b,nc,h)
    h_in = np.zeros((b, nc + 1, h, p, n))
    for c in range(1, nc + 1):
        for c0 in range(c):
            h_in[:, c] += (np.prod(decay[:, c0 + 1:c], axis=1)[..., None, None]
                           * st[:, c0])
    y = np.zeros((b, s, h, p))
    for bi in range(b):
        for c, rs in enumerate(rows):
            for hi in range(h):
                for i, t in enumerate(rs):
                    ci = cum[bi, c, hi]
                    y[bi, t, hi] = np.exp(ci[i]) * (h_in[bi, c, hi]
                                                    @ cm[bi, t])
                    for j, r in enumerate(rs[:i + 1]):
                        y[bi, t, hi] += (cb[bi, c, i, j]
                                         * np.exp(ci[i] - ci[j])
                                         * dt[bi, r, hi] * x[bi, r, hi])
    return {"cum": cum, "cb": cb, "chunk_states": st,
            "states_in": h_in[:, :nc], "h_final": h_in[:, nc], "y": y}


@pytest.mark.parametrize("stage", ["cum", "cb", "chunk_states", "states_in",
                                   "h_final", "y"])
def test_each_stage_matches_its_direct_formula(stage):
    """float64, 1e-10: b=2, S=13 in chunks of 5 (a ragged last chunk of
    3), P=3, N=4."""
    args = [a.astype(np.float64) for a in _inputs(2, 13, 2, 3, 4, seed=6)]
    got = ref.ssd_stages(*_t(*args), chunk=5)[stage]
    want = _direct_stages(*args, q=5)[stage]
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


# (b, S, H, P, N, chunk): the served widths at S = 1019 and the shapes of
# the card's ssd_scan phase; then Zamba2's served widths (N = 64, half the
# kernel's 128-column state tile) at the ssd_scan-zamba phase's S.
PLANNED = [(1, 1019, 48, 64, 128, 128), (1, 448, 48, 64, 128, 128),
           (2, 300, 8, 64, 128, 128), (1, 50, 8, 64, 128, 128),
           (1, 1, 8, 64, 128, 128), (1, 200, 3, 40, 100, 128),
           (1, 1019, 64, 64, 64, 128), (1, 448, 64, 64, 64, 128)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", PLANNED)
def test_scratch_is_shaped_as_the_plain_stages(b, s, h, p, n, chunk):
    """The scratch the wrapper allocates has the shapes of the plain stages'
    outputs (taken on meta tensors)."""
    meta = [torch.empty(shape, device="meta") for shape in
            ((b, s, h, p), (b, s, h), (h,), (b, s, n), (b, s, n))]
    stages = ref.ssd_stages(*meta, chunk=chunk)
    assert ops.scratch_shapes(b, s, h, p, n, chunk) == {
        "cum": tuple(stages["cum"].shape), "cb": tuple(stages["cb"].shape),
        "states": tuple(stages["chunk_states"].shape)}
