"""A run with the timed path broken underneath comes out not correct, once for
each fault a serving cell can have; a sound run comes out correct. The runs
skip the look for a card and serve a tiny frame size on the CPU (the
program's plain versions of its kernels)."""

import pytest
import torch

from portbench import run
from portbench.tests.util import cpu, tiny


def _brighten(step, rows: slice, cols: slice):
    """Every other answer altered where it is produced: the block ``rows`` x
    ``cols`` of its frame brightened by 4 levels."""
    calls = []

    def f(pairs):
        out = step(pairs)
        calls.append(1)
        if len(calls) % 2 == 0:
            out = out.clone()
            blk = out[:, :, rows, cols]
            out[:, :, rows, cols] = torch.clamp(blk.int() + 4, 0, 255).to(torch.uint8)
        return out
    return f


def _altered(step):
    """A block of a third of every other answer's frame brightened."""
    return _brighten(step, slice(8, 40), slice(8, 48))


def _altered_whole(step):
    """Every other answer's whole frame brightened. The int8 configuration's
    own rounding leaves some 4 % of a tiny frame's values 2 levels off its
    float32 reference, and its number weighs an alteration against that: a
    block of a third of the frame reads 5.3, under the limit."""
    return _brighten(step, slice(None), slice(None))


def _half_batch(step):
    """Half of the batch left out: the second half's answers are the first's."""
    def f(pairs):
        out = step(pairs[: len(pairs) // 2])
        return torch.cat([out, out])
    return f


def _unchanged(step):
    """A step that hands back its input's left frame as the frame between."""
    def f(pairs):
        step(pairs)
        return torch.as_tensor(pairs[:, :1]).clone()
    return f


def _run(name, wrap=None, traced=False, batch=None):
    parts = tiny(name)
    if batch:  # the cell's configuration and limit on batches of ``batch`` pairs
        parts["traffic"].update(batch=batch, pool=2 * batch)
    return run.run(name, 2 ** 33 + 11, 0.5, traced, cpu(), parts=parts, wrap_step=wrap)


@pytest.mark.parametrize("name", ["bf16-1080p-x2", "int8-1080p-x2"])
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("name,wrap,batch", [
    ("bf16-1080p-x2", _altered, None), ("int8-1080p-x2", _altered_whole, None),
    ("bf16-1080p-x2", _half_batch, 8), ("bf16-1080p-x2", _unchanged, None),
], ids=["answer-altered-bf16", "answer-altered-int8", "half-batch", "unchanged"])
def test_broken_step_is_not_correct(name, wrap, batch):
    out = _run(name, wrap, batch=batch)
    assert not out["correct"], out["checks"]


def test_traced_run_judges_its_window():
    out = _run("bf16-1080p-x2", _half_batch, traced=True, batch=8)
    assert not out["correct"] and "busy_s" in out["device"] and "breakdown" in out
