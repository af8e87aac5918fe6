"""What the port's test files share: one torch CPU thread per test, and for
the packed-path convs inputs from a seed, the PSNR they state their bf16 bars
in, and the switch that runs a JAX packed conv through its Pallas body in
interpret mode.

These files hold at most eleven cases each. pytest-xdist hands the files with
the most cases out first, so one new large file would change which files share
a worker process, and with it what the tests of the JAX package draw from the
generator that ``conftest.py`` shares across a session."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rrin_tpu.ops import conv_packed as jcp
from rrin_tpu_torch.ops import conv_packed as tcp

# float32 on both sides, the same function in another summation order: the
# JAX package's own tests of these kernels use 1e-5 to 3e-4 at these sizes.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 through the interpreted Pallas body: the JAX package's own bar for a
# bf16 kernel against its float reference is 40 dB.
BF16_PSNR_DB = 40.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test file's torch CPU ops on one thread (a test file imports
    this fixture to take it). The suite runs in several pytest-xdist workers, and
    with each worker's OpenMP pool as wide as the machine the pools spin
    against each other: on an 8-core host a 48x64 int8 cascade took 36 s in
    each of three workers of eight threads, 0.9-1.1 s in each of six workers
    of one thread, 0.2 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fresh_rng():
    """A generator of the file's own, fresh for every test: the cases do not
    depend on the order of the tests and draw nothing from the session's
    shared generator."""
    return np.random.default_rng(2026)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def case(rng, shape_x, k, cin, cout):
    x = (rng.random(shape_x, dtype=np.float32) - 0.5)
    w = ((rng.random((k, k, cin, cout), dtype=np.float32) - 0.5) * 0.4)
    b = rng.random(cout, dtype=np.float32) - 0.5
    return x, w, b


def psnr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    peak = float(np.abs(want).max()) or 1.0
    return 10 * np.log10(peak * peak / max(float(np.mean((got - want) ** 2)), 1e-20))


def interpreted(fn, *args, **kw):
    """Run a JAX packed conv through its Pallas body in interpret mode."""
    jcp._FORCE_KERNEL = True
    try:
        with pltpu.force_tpu_interpret_mode():
            return fn(*args, **kw)
    finally:
        jcp._FORCE_KERNEL = False


def gather(frag, wt, cins, cchunk, n_tiles, kk=16):
    """Check every element of a fragment tensor (the order that
    ``conv_packed._weight_fragments`` documents, ``kk`` channels per mma step:
    16 bf16, 32 int8) against a numpy gather of the weights ``wt`` (ky, taps,
    sum(cins), n_out)."""
    wt = wt.to(torch.bfloat16).float().numpy()
    n_out = wt.shape[3]
    starts, rows, row = [], [], 0
    for c in cins:
        for ch in range(-(-c // cchunk)):
            starts.append(row + ch * cchunk)
            rows.append(row + c)
        row += c
    f = frag.float().numpy()
    assert f.shape[1] == len(starts)
    for idx in np.ndindex(*f.shape):
        cb, ch, dy, tap, k16, nt, g, tig, r, p = idx
        ci = starts[ch] + k16 * kk + r * (kk // 2) + tig * (kk // 8) + p
        co = (cb * n_tiles + nt) * 8 + g
        want = wt[dy, tap, ci, co] if ci < rows[ch] and co < n_out else 0.0
        assert f[idx] == want, idx


def sm90_offset(ci, n, dy, tap, cchunk, n_tiles, k, ntaps, n_chunks, q, plane=0):
    """Byte offset in a weight buffer of the Hopper core (``csrc/conv_sm90.cuh``)
    at which it reads padded channel-in ci of channel-out n at (dy, tap): the
    wgmma B descriptor's view of
    [cb][chunk][dy][tap][k-step][n-tile][r][g][16 bytes]; float32 (``q`` =
    F32) [...][k-step][plane][n-tile][r][g][16 bytes], the lo plane one B
    tile (8 channels x n_tiles*8) after the hi plane."""
    f32 = q == tcp.F32
    es, kk = (4, 8) if f32 else ((1, 32) if q else (2, 16))
    planes = 2 if f32 else 1
    big_n = n_tiles * 8
    tap_bytes = cchunk * big_n * es * planes
    cb, nn = divmod(n, big_n)
    ch, cc = divmod(ci, cchunk)
    ks, kin = divmod(cc, kk)
    r, e = divmod(kin, kk // 2)
    stage = ((cb * n_chunks + ch) * k + dy) * ntaps + tap
    return (stage * tap_bytes + (ks * planes + plane) * big_n * 32 + (nn // 8) * 256 + r * 128
            + (nn % 8) * 16 + e * es)


def sm90_rows(cins, cchunk):
    """The weight row (channel of the concat) that each padded channel of the
    Hopper core's K-loop holds, or None for padding: chunks run operand by
    operand, each operand's channels padded to whole chunks, so no chunk
    holds channels of two operands."""
    rows, row = [], 0
    for c in cins:
        span = -(-c // cchunk) * cchunk
        rows += [row + i if i < c else None for i in range(span)]
        row += c
    return rows


def check_sm90_layout(pr, ref, k, q, cins=None):
    """Every byte of ``pr["wfrag"]`` (a ``prep_*`` result in the Hopper
    core's layout, for operands of ``cins`` channels, one operand by
    default) that the core reads holds ``ref[dy, tap, ci, n]``
    (bf16-rounded, the int8 code, or in float32, ``q`` = F32, its hi TF32
    part in one plane and its lo part in the other), zero where an operand's
    chunk or the output channels are padding, and the address formula covers
    the buffer once."""
    f32 = q == tcp.F32
    if f32:
        hi = tcp._tf32(ref)
        planes = [hi.numpy(), tcp._tf32(ref - hi).numpy()]
        dtype, order, es = torch.float32, tcp._SM90_F32_ORDER, 4
    else:
        planes = [ref.numpy() if q else ref.to(torch.bfloat16).float().numpy()]
        dtype, order, es = (torch.int8, tcp._SM90_ORDER, 1) if q else (
            torch.bfloat16, tcp._SM90_ORDER, 2)
    n_out, ntaps = ref.shape[3], ref.shape[1]
    cchunk, n_tiles, n_cb = pr["plan"]
    rows = sm90_rows(cins or (ref.shape[2],), cchunk)
    assert n_cb * n_tiles * 8 >= n_out
    mem = pr["wfrag"].permute(*order)
    assert mem.is_contiguous() and mem.dtype == dtype
    flat = mem.reshape(-1).float().numpy()
    n_chunks = len(rows) // cchunk
    assert flat.size == n_cb * n_chunks * k * ntaps * cchunk * n_tiles * 8 * len(planes)
    seen = np.zeros(flat.size, bool)
    for plane, vals in enumerate(planes):
        for dy in range(k):
            for tap in range(ntaps):
                for ci, row in enumerate(rows):
                    for n in range(n_cb * n_tiles * 8):
                        off = sm90_offset(ci, n, dy, tap, cchunk, n_tiles, k, ntaps, n_chunks,
                                          q, plane)
                        assert off % es == 0
                        want = vals[dy, tap, row, n] if row is not None and n < n_out else 0.0
                        assert flat[off // es] == want, (plane, dy, tap, ci, n)
                        seen[off // es] = True
    assert seen.all()
