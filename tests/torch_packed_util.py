"""What the test files of the port's packed-path convs share: inputs from a
seed, the PSNR they state their bf16 bars in, and the switch that runs a JAX
packed conv through its Pallas body in interpret mode.

These files hold at most eleven cases each. pytest-xdist hands the files with
the most cases out first, so one new large file would change which files share
a worker process, and with it what the tests of the JAX package draw from the
generator that ``conftest.py`` shares across a session."""

import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from rrin_tpu.ops import conv_packed as jcp

# float32 on both sides, the same function in another summation order: the
# JAX package's own tests of these kernels use 1e-5 to 3e-4 at these sizes.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 through the interpreted Pallas body: the JAX package's own bar for a
# bf16 kernel against its float reference is 40 dB.
BF16_PSNR_DB = 40.0


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


def gather(frag, wt, cins, cchunk, n_tiles):
    """Check every element of a fragment tensor (the order that
    ``conv_packed._weight_fragments`` documents) against a numpy gather of the
    weights ``wt`` (ky, taps, sum(cins), n_out)."""
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
        ci = starts[ch] + k16 * 16 + r * 8 + tig * 2 + p
        co = (cb * n_tiles + nt) * 8 + g
        want = wt[dy, tap, ci, co] if ci < rows[ch] and co < n_out else 0.0
        assert f[idx] == want, idx
