"""The port's SSD scan against the JAX package's.

``ssd_scan_plain`` (the CPU side of ``kernels.ops.ssd_scan``, and the
plain version the CUDA kernel is held against on the card) and the
port's sequential oracle ``ref_ssd`` are held against the Pallas kernel
run in ``interpret=True`` and the JAX ``ref_ssd``, on the sweep of
``tests/test_kernels.py``.  Inputs are drawn with numpy and handed to
both frameworks.

Tolerance: 1e-3 in fp32, as ``tests/test_kernels.py`` takes for the scan
(prefix sums and chunk products in another summation order), and 2e-2
in bf16 (both sides round the fp32 result to bf16).  The CUDA kernel
itself runs only on a card: ``tests/test_torch_cuda.py`` holds it against
``ssd_scan_plain``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.ssd_scan import ssd_scan_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssd_scan as SSD

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SWEEP = [(64, 2, 16, 1, 16, 16),          # tests/test_kernels.py:98-116
         (70, 4, 16, 2, 32, 32),          # ragged tail + grouped B/C
         (32, 8, 64, 1, 128, 8)]


def inputs(seed, B, S, H, P, G, N, *, init=False, dtype="float32"):
    """(JAX args, torch args, JAX state, torch state); x/B/C in dtype,
    dt/A/state fp32, as the model hands them to the scan."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, P)),
            np.logaddexp(0.0, rng.standard_normal((B, S, H))),   # softplus
            -np.exp(rng.standard_normal(H) * 0.3),
            rng.standard_normal((B, S, G, N)) * 0.5,
            rng.standard_normal((B, S, G, N)) * 0.5]
    state = rng.standard_normal((B, H, P, N)) if init else None
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j, t = [], []
    for i, a in enumerate(arrs):
        a = a.astype(np.float32)
        low = i in (0, 3, 4)                       # x, B, C
        j.append(jnp.asarray(a, jd if low else jnp.float32))
        t.append(torch.from_numpy(a.copy()).to(td if low else torch.float32))
    if state is None:
        return j, t, None, None
    state = state.astype(np.float32)
    return j, t, jnp.asarray(state), torch.from_numpy(state.copy())


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S,H,P,G,N,chunk", SWEEP)
def test_plain_matches_pallas_kernel(S, H, P, G, N, chunk):
    j, t, _, _ = inputs(S + N, 2, S, H, P, G, N)
    jy, jf = ssd_scan_kernel(*j, chunk=chunk, interpret=True)
    ty, tf = SSD.ssd_scan_plain(*t, chunk=chunk)
    close(ty, jy, **TOL["float32"])
    close(tf, jf, **TOL["float32"])


@pytest.mark.parametrize("S,H,P,G,N,chunk", SWEEP)
def test_ref_ssd_matches_jax_ref(S, H, P, G, N, chunk):
    j, t, _, _ = inputs(S + N, 2, S, H, P, G, N)
    jy, jf = JR.ref_ssd(*j)
    ty, tf = TR.ref_ssd(*t)
    close(ty, jy, **TOL["float32"])
    close(tf, jf, **TOL["float32"])


@pytest.mark.parametrize("side", ["plain-vs-pallas", "ref-vs-ref"])
def test_initial_state(side):
    """tests/test_kernels.py:119-135: a nonzero initial state carried in
    (the prefill-with-cache path)."""
    j, t, js, ts = inputs(9, 1, 40, 2, 16, 1, 16, init=True)
    if side == "plain-vs-pallas":
        jy, jf = ssd_scan_kernel(*j, chunk=16, initial_state=js,
                                 interpret=True)
        ty, tf = SSD.ssd_scan_plain(*t, chunk=16, initial_state=ts)
    else:
        jy, jf = JR.ref_ssd(*j, initial_state=js)
        ty, tf = TR.ref_ssd(*t, initial_state=ts)
    close(ty, jy, **TOL["float32"])
    close(tf, jf, **TOL["float32"])


@pytest.mark.parametrize("init", [False, True])
def test_plain_matches_pallas_kernel_bf16(init):
    """bf16 x/B/C, as the model feeds the scan; fp32 dt, A and state."""
    j, t, js, ts = inputs(11, 2, 70, 4, 16, 2, 32, init=init,
                          dtype="bfloat16")
    jy, jf = ssd_scan_kernel(*j, chunk=32, initial_state=js, interpret=True)
    ty, tf = SSD.ssd_scan_plain(*t, chunk=32, initial_state=ts)
    assert ty.dtype == torch.bfloat16 and tf.dtype == torch.float32
    close(ty, jy, **TOL["bfloat16"])
    close(tf, jf, **TOL["bfloat16"])


@pytest.mark.parametrize("chunk", [8, 24, 64, 512])
def test_result_does_not_depend_on_the_chunk(chunk):
    """The chunk (and ``min(chunk, max(S, 8))`` for short inputs) changes
    the summation, not the result."""
    _, t, _, ts = inputs(12, 1, 50, 4, 16, 2, 16, init=True)
    ty, tf = SSD.ssd_scan_plain(*t, chunk=chunk, initial_state=ts)
    ry, rf = TR.ref_ssd(*t, initial_state=ts)
    close(ty, ry, **TOL["float32"])
    close(tf, rf, **TOL["float32"])


def test_ops_takes_cpu_tensors_to_the_plain_version():
    _, t, _, ts = inputs(13, 2, 24, 16, 16, 1, 16, init=True)
    before = SSD.ssd_scan_cuda.launches
    y, f = ops.ssd_scan(*t, chunk=32, initial_state=ts)
    py, pf = SSD.ssd_scan_plain(*t, chunk=32, initial_state=ts)
    assert torch.equal(y, py) and torch.equal(f, pf)
    assert SSD.ssd_scan_cuda.launches == before
    assert "ssd_scan" in ops.launch_counts()


def test_no_fallback_off_the_cpu():
    """A mix of devices raises; the CUDA wrapper refuses CPU tensors
    rather than running the plain version."""
    _, t, _, _ = inputs(14, 1, 16, 2, 16, 1, 16)
    with pytest.raises(ValueError, match="CPU or all on"):
        ops.ssd_scan(t[0].to("meta"), *t[1:], chunk=8)
    with pytest.raises(ValueError, match="CUDA device"):
        SSD.ssd_scan_cuda(*t, chunk=8)


def margin(got, want, tol=2e-2):
    """max |got - want| / (tol + tol |want|): below 1 passes the card's
    allclose at rtol = atol = tol."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def split_bf16(t):
    """An fp32 operand as the CUDA kernel's two bf16 operands: the high
    part and the low part of what it leaves (their sum keeps about 16 bits
    of the mantissa), each back in fp32."""
    hi = t.to(torch.bfloat16).float()
    return [hi, (t - hi).to(torch.bfloat16).float()]


@pytest.mark.parametrize("S,H,P,G,N,chunk", [
    (100, 16, 16, 1, 16, 32),        # mamba2-780m .reduced(): P = N = 16
    (891, 48, 64, 1, 128, 256),      # full width, the engine's longest prompt
], ids=["reduced", "full-width-891"])
def test_kernel_operand_rounding_inside_the_card_tolerance(monkeypatch, S, H,
                                                           P, G, N, chunk):
    """The bf16 kernel's products take x, B or C exactly as they arrive
    and split the other, fp32 operand (the decayed dt·x weights, the
    carried state, W) into a bf16 high and low part.  Emulated here by
    running the plain version with every einsum's first operand, the fp32
    one, taken as those parts (C, in C Bᵀ, splits into itself and zero),
    its y and final state stay inside the 2e-2 at which chip_smoke.py and
    tests/test_torch_cuda.py hold the kernel against the fp32 plain
    version.  Prints the margins (1 = at the tolerance), also with the low
    parts dropped, which is not asserted."""
    _, t, _, ts = inputs(15, 1, S, H, P, G, N, init=True, dtype="bfloat16")
    want_y, want_f = SSD.ssd_scan_plain(*t, chunk=chunk, initial_state=ts)
    einsum = torch.einsum
    margins = {}
    for name, split in [("hi+lo", split_bf16),
                        ("hi only", lambda a: split_bf16(a)[:1])]:
        def split_einsum(eq, a, b, split=split):
            return sum(einsum(eq, part, b) for part in split(a))
        with monkeypatch.context() as m:
            m.setattr(torch, "einsum", split_einsum)
            y, f = SSD.ssd_scan_plain(*t, chunk=chunk, initial_state=ts)
        assert y.dtype == torch.bfloat16
        margins[name] = (margin(y, want_y), margin(f, want_f))
    print(f"SSD operand rounding [1,{S},{H},{P}] N={N} chunk={chunk}: "
          + "; ".join(f"{k}: y margin {m[0]:.3f}, final state margin "
                      f"{m[1]:.3g}" for k, m in margins.items()))
    assert max(margins["hi+lo"]) < 1, margins
