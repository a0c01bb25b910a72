"""The port's input pipeline (data/prefetch.py) and the loader / scheduler state it
rests on, in the cases of tests/unit/test_prefetch.py that apply to one process: the
same batches in the same order as the synchronous path and as the JAX package's
pipeline, the consumed position checkpointed and replayed exactly, errors at the
synchronous path's position, and shutdown. The CUDA copy path (pinned memory, a side
stream) runs on the card in chip_smoke.py's main path 9."""

import sys
import threading
import time

import numpy as np
import pytest

from automodel_tpu.data.collate import stack_batches as jax_stack
from automodel_tpu.data.loader import DataLoader as JaxLoader
from automodel_tpu.data.prefetch import InputPipeline as JaxPipeline
from automodel_tpu.data.prefetch import PrefetchConfig as JaxPrefetchConfig
from automodel_tpu.training.step_scheduler import StepScheduler as JaxScheduler
from automodel_tpu_torch.data.collate import stack_batches
from automodel_tpu_torch.data.loader import DataLoader
from automodel_tpu_torch.data.prefetch import (DevicePrefetcher, HostPrefetcher, InputPipeline,
                                               PrefetchConfig)
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _dataset(n=32, width=4):
    return [{"x": np.full((width,), i, np.int32)} for i in range(n)]


def _collate(samples):
    return {"x": np.stack([s["x"] for s in samples])}


def _make(n=32, grad_acc=2, batch_size=2, num_epochs=1, max_steps=None, seed=3, data=None):
    dl = DataLoader(data or _dataset(n), batch_size=batch_size, collate_fn=_collate, seed=seed)
    return StepScheduler(grad_acc_steps=grad_acc, num_epochs=num_epochs, max_steps=max_steps,
                         dataloader=dl), dl


def _pipeline(sched, dl, enabled, put_fn=None, **cfg):
    return InputPipeline(sched, dl, stack_batches, put_fn or (lambda s: s),
                         PrefetchConfig(enabled=enabled, **cfg))


def _drain(pipeline):
    out = []
    while (item := pipeline.get()) is not None:
        out.append(item)
    pipeline.close()
    return out


def _xs(items):
    return [(b.step, b.stack["x"].tolist()) for b in items]


@pytest.mark.parametrize("host_depth,device_depth,num_epochs",
                         [(1, 1, 1), (2, 2, 1), (4, 3, 1), (2, 2, 3)])
def test_same_batches_as_sync_and_as_jax(host_depth, device_depth, num_epochs):
    n = 30  # 15 batches an epoch: the last step of each epoch is a partial group
    ref = _drain(_pipeline(*_make(n, num_epochs=num_epochs), enabled=False))
    got = _drain(_pipeline(*_make(n, num_epochs=num_epochs), enabled=True,
                           host_depth=host_depth, device_depth=device_depth))
    assert _xs(got) == _xs(ref) and len(ref) == 8 * num_epochs
    jdl = JaxLoader(_dataset(n), batch_size=2, collate_fn=_collate, seed=3)
    jsched = JaxScheduler(grad_acc_steps=2, num_epochs=num_epochs, dataloader=jdl,
                          handle_sigterm=False)
    jpipe = JaxPipeline(jsched, jdl, jax_stack, lambda s: s,
                        JaxPrefetchConfig(enabled=True, host_depth=host_depth,
                                          device_depth=device_depth))
    want = []
    while (item := jpipe.get()) is not None:
        want.append(item)
        assert item.client_state == got[len(want) - 1].client_state
    jpipe.close()
    assert _xs(got) == _xs(want)


def test_client_states_track_consumed_and_replay_in_flight():
    ref = _drain(_pipeline(*_make(64, max_steps=12), enabled=False))
    sched, dl = _make(64, max_steps=12)
    start = {"step_scheduler": sched.state_dict(), "dataloader": dl.state_dict()}
    pf = _pipeline(sched, dl, enabled=True, host_depth=4, device_depth=2)
    assert pf.client_states() == start  # the worker may have run ahead already
    consumed = [pf.get() for _ in range(5)]
    snap = pf.client_states()
    assert snap["step_scheduler"]["step"] == 5 and snap["dataloader"]["cursor"] == 10
    deadline = time.monotonic() + 5.0
    while sched.step <= 5 and time.monotonic() < deadline:  # the worker runs ahead
        time.sleep(0.01)
    assert sched.step > 5
    pf.close()
    sched2, dl2 = _make(64, max_steps=12)
    sched2.load_state_dict(snap["step_scheduler"])
    dl2.load_state_dict(snap["dataloader"])
    resumed = _drain(_pipeline(sched2, dl2, enabled=True))
    assert _xs(consumed + resumed) == _xs(ref)
    sync = _pipeline(*_make(max_steps=4), enabled=False)
    sync.get()
    assert sync.client_states() == {}


class Boom(RuntimeError):
    pass


def _positions(pipeline):
    out = []
    try:
        while (item := pipeline.get()) is not None:
            out.append(item.step)
    except Boom:
        out.append("boom")
    pipeline.close()
    return out


@pytest.mark.parametrize("where", ["dataset", "put_fn"])
def test_errors_surface_at_the_sync_position(where):
    def build(enabled):
        data = _dataset(32)
        if where == "dataset":
            class Data(list):
                def __getitem__(self, i):
                    if i == 9:  # some batch of step 2 or later, in order
                        raise Boom("bad row")
                    return list.__getitem__(self, i)
            data = Data(data)
        calls = []

        def put(stack):
            calls.append(1)
            if where == "put_fn" and len(calls) == 4:
                raise Boom("copy failed")
            return stack

        return _pipeline(*_make(data=data), enabled=enabled, put_fn=put, host_depth=3,
                         device_depth=2)

    want = _positions(build(False))
    assert want[-1] == "boom" and len(want) > 1
    assert _positions(build(True)) == want


def test_close_is_idempotent_and_unblocks_a_full_queue():
    sched, dl = _make(64)
    host = HostPrefetcher(sched, dl, stack_batches, depth=1)
    deadline = time.monotonic() + 5.0
    while host.ready < 1 and time.monotonic() < deadline:  # the worker blocks on a full queue
        time.sleep(0.01)
    host.close()
    host.close()
    assert not host._thread.is_alive()
    pipe = _pipeline(*_make(), enabled=True)
    pipe.close()
    pipe.close()


def test_many_pipelines_at_once_keep_their_order():
    """16 prefetching pipelines (32 threads) with a very short switch interval: each
    still yields exactly the synchronous sequence, so no update of the scheduler or
    loader state is lost between the worker and the consumer."""
    ref = _xs(_drain(_pipeline(*_make(64, num_epochs=2), enabled=False)))
    results = [None] * 16

    def run(i):
        results[i] = _xs(_drain(_pipeline(*_make(64, num_epochs=2), enabled=True,
                                          host_depth=1 + i % 3, device_depth=1 + i % 2)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert all(r == ref for r in results)


def test_device_prefetcher_depth_and_ready():
    sched, dl = _make(64, max_steps=8)
    host = HostPrefetcher(sched, dl, stack_batches, depth=4)
    puts = []
    dev = DevicePrefetcher(host, lambda s: puts.append(1) or {"x": s["x"] + 1000}, depth=3)
    deadline = time.monotonic() + 5.0
    while host.ready < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    first = dev.get()
    assert first.step == 1 and first.stack["x"].min() >= 1000
    assert dev.ready <= 3 and len(puts) == 1 + dev.ready
    host.close()


def test_config_and_loader_state():
    assert not PrefetchConfig.from_config(None).enabled
    assert PrefetchConfig.from_config({"enabled": True, "host_depth": 3, "other": 1}).host_depth == 3
    for bad in ({"host_depth": 0}, {"device_depth": 0}):
        with pytest.raises(ValueError):
            PrefetchConfig(**bad)
    _, dl = _make(30)
    dl.fast_forward(17)  # 15 batches an epoch
    assert (dl.epoch, dl.state_dict()["cursor"], dl.consumed_examples) == (1, 2, 4)
    with pytest.raises(ValueError, match="batch_size"):
        DataLoader(_dataset(8), batch_size=4).load_state_dict(dl.state_dict())
    with pytest.raises(ValueError):
        dl.fast_forward(-1)
    jdl = JaxLoader(_dataset(30), batch_size=2, collate_fn=_collate, seed=3)
    jdl.fast_forward(17)
    assert jdl.state_dict() == dl.state_dict()
