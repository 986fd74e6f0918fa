# SPDX-License-Identifier: Apache-2.0
"""The port's device-resident slot table (``engine/slots.py``) on the CPU:
the cases of ``tests/test_slots.py`` (the JAX package's), plus the refusal
of a batch that names a slot twice. Values are exact (small f32 sums)."""

import asyncio

import numpy as np
import pytest
import torch

from streamkit_tpu_torch.engine.batcher import DeviceBatcher
from streamkit_tpu_torch.engine.slots import SlotTable


def _counter_row():
    return {"count": torch.zeros((), dtype=torch.float32), "hist": torch.zeros((4,), dtype=torch.float32)}


def test_alloc_free_reset():
    t = SlotTable(_counter_row, max_slots=4, device="cpu")
    slots = [t.alloc() for _ in range(4)]
    assert sorted(slots) == [0, 1, 2, 3]
    assert t.in_use == 4
    with pytest.raises(RuntimeError, match="exhausted"):
        t.alloc()
    t.free(slots[0])
    assert t.in_use == 3
    again = t.alloc()
    assert again == slots[0]


def test_batched_step_updates_only_submitting_rows():
    t = SlotTable(_counter_row, max_slots=8, device="cpu")
    a, b, c = t.alloc(), t.alloc(), t.alloc()

    def fn(rows, increments):
        new_rows = {
            "count": rows["count"] + increments,
            "hist": rows["hist"] + increments[:, None],
        }
        return new_rows, rows["count"] + increments  # output: new counts

    step = t.make_step(fn)
    out = step(np.asarray([a, c]), np.asarray([1.0, 10.0], np.float32))
    np.testing.assert_array_equal(out.numpy(), [1.0, 10.0])
    out = step(np.asarray([a, b]), torch.tensor([1.0, 5.0]))
    np.testing.assert_array_equal(out.numpy(), [2.0, 5.0])  # a accumulated, b fresh
    out = step(torch.tensor([c]), np.asarray([1.0], np.float32))
    np.testing.assert_array_equal(out.numpy(), [11.0])
    np.testing.assert_array_equal(t.rows([a, b, c])["hist"].numpy(), [[2.0] * 4, [5.0] * 4, [11.0] * 4])
    # freeing resets the row
    t.free(c)
    c2 = t.alloc()
    assert c2 == c
    out = step(np.asarray([c2]), np.asarray([2.0], np.float32))
    np.testing.assert_array_equal(out.numpy(), [2.0])


def test_slot_table_through_batcher():
    """Sessions submit (slot, input) through the batcher; state stays put.
    The kind takes host inputs, so no padding row repeats a slot."""

    async def main():
        t = SlotTable(_counter_row, max_slots=8, device="cpu")

        def fn(rows, xs):
            return {"count": rows["count"] + xs, "hist": rows["hist"]}, rows["count"] + xs

        step = t.make_step(fn)
        b = DeviceBatcher(tick_ms=5.0, device="cpu")
        b.register("counter", lambda slot_ids, xs: step(slot_ids, xs), host_inputs=True)
        b.start()
        slots = [t.alloc() for _ in range(3)]  # batches of 3: padding would repeat a slot

        async def session(slot, n):
            total = 0.0
            for i in range(n):
                total = await b.submit("counter", np.int32(slot), np.float32(1.0))
            return float(total)

        results = await asyncio.gather(*(session(s, 5) for s in slots))
        b.stop()
        return results, b.stats()

    results, stats = asyncio.run(main())
    assert results == [5.0, 5.0, 5.0]
    assert stats["device_calls"] < stats["submissions"]  # batching happened


def test_batch_with_a_repeated_slot_is_refused():
    """A repeated slot would make the in-place write-back order-dependent
    (undefined on CUDA): the step refuses the batch and leaves the state as
    it was. So does a slot outside the table."""
    t = SlotTable(_counter_row, max_slots=4, device="cpu")
    a, b = t.alloc(), t.alloc()
    step = t.make_step(lambda rows, xs: ({"count": rows["count"] + xs, "hist": rows["hist"]}, xs))
    step(np.asarray([a]), np.asarray([3.0], np.float32))
    with pytest.raises(ValueError, match="twice"):
        step(np.asarray([a, b, a]), np.asarray([1.0, 1.0, 1.0], np.float32))
    with pytest.raises(IndexError):
        step(np.asarray([4]), np.asarray([1.0], np.float32))
    np.testing.assert_array_equal(t.rows([a, b])["count"].numpy(), [3.0, 0.0])


def test_slot_table_needs_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotTable(_counter_row, max_slots=2)
