"""The runners' transfer ring (``pipeline/stream.py::TransferRing``) and the
runners that carry their batches through it (``pipeline/runners.py``).

- The ring alone, on the CPU with a recording stand-in for the CUDA
  events, driven by a ``PipelinedDispatch`` of depth d over d + 1 slots:
  every batch's result comes back, a slot's frames are still the batch's
  own when its result is fetched (a slot is rewritten only after its batch
  was fetched), the counts of waits follow the events, and a ring with d
  slots refuses to restage a slot whose batch is still in flight.
- ``run_vo_sequence`` at pipeline depths 1, 2 and 3, with a short last
  batch and another frame in every step, bit-equal to a loop that steps
  the batches one at a time and fetches each with ``.cpu()``; ``stats``
  counts the batches and its waits lie between 0 and that count. On the
  CPU at 96x128 (the settings of ``tests/test_torch_profiling.py``), on
  the card (marked ``cuda``) at KITTI 00's 376x1241 with the benchmark's
  step (1,024 keypoints, LMedS over 512 hypotheses), where the card is
  slower than the host and an early rewrite of a slot would show.
- ``_extract_pairs`` (pairs that are not consecutive, so up to 2B frames
  a slot, gathered from the upload) bit-equal across depths 1, 2 and 3,
  with the ring's waits in its ``stats``.
- On the card: a replayed batch's staging, upload, step and result copy
  make no host sync (``torch.cuda.set_sync_debug_mode("error")``).

No JAX: the card tests run on a GPU machine with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.geometry.camera import Pinhole
from epivo_tpu_torch.pipeline import config as tconfig, runners, stream
from epivo_tpu_torch.utils import profiling

HS, WS = 96, 128


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The ring alone.
# ---------------------------------------------------------------------------


class RecordingEvent:
    """A CUDA event stand-in: pending from ``record()`` until
    ``synchronize()``, as on a card that is always behind the host."""

    def __init__(self):
        self.done = True
        self.records = 0

    def record(self):
        self.done = False
        self.records += 1

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_ring_slots_rotate_after_fetch(depth):
    events = []

    def event():
        events.append(RecordingEvent())
        return events[-1]

    ring = stream.TransferRing("cpu", depth + 1, event=event)
    n_batches = 7
    log, inflight = [], {}

    def dispatch(k):
        # A batch of 2-4 frames (the slots' buffers grow and shrink), each
        # filled with its batch and position.
        frames = [np.full((3, 5), 10 * k + i, np.float32) for i in range(2 + k % 3)]
        slot = ring.put(frames)
        log.append(("put", id(slot), k))
        up = ring.upload(slot)  # on the CPU: the slot's own buffer
        ring.send(slot, up.sum(dim=(1, 2)))
        inflight[k] = (up, frames)
        return slot

    def on_ready(slot, k):
        got = ring.fetch(slot)
        log.append(("fetch", id(slot), k))
        up, frames = inflight.pop(k)
        # The slot still holds this batch's frames: nothing restaged it.
        np.testing.assert_array_equal(up.numpy(), np.stack(frames))
        np.testing.assert_array_equal(got, np.stack(frames).sum(axis=(1, 2)))

    pipe = stream.PipelinedDispatch(on_ready, depth=depth)
    for k in range(n_batches):
        pipe.submit(lambda k=k: dispatch(k), k)
    pipe.flush()
    assert not inflight
    # Each put into a slot follows the fetch of the slot's previous batch.
    last = {}
    for op, slot, k in log:
        if op == "put":
            assert last.get(slot, "fetch") == "fetch", k
        last[slot] = op
    assert len({s for _, s, _ in log}) == min(depth + 1, n_batches)
    # Two events a slot; every fetch and every restaging found its event
    # pending (the stand-in card is always behind).
    assert len(events) == 2 * (depth + 1)
    assert ring.stats == {"batches": n_batches, "fetch_waited": n_batches,
                          "slot_waited": n_batches - (depth + 1)}

    short = stream.TransferRing("cpu", depth, event=event)
    with pytest.raises(RuntimeError, match="before its batch was fetched"):
        pipe = stream.PipelinedDispatch(lambda slot, k: short.fetch(slot), depth=depth)
        for k in range(depth + 1):
            pipe.submit(lambda: short.put([np.zeros((2, 2), np.float32)]), k)


# ---------------------------------------------------------------------------
# The runners through the ring.
# ---------------------------------------------------------------------------


def _cpu_case():
    cfg = tconfig.VOConfig(
        camera=Pinhole(fx=110.0, fy=110.0, cx=WS / 2, cy=HS / 2, width=WS, height=HS),
        frontend=tconfig.FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                        klt_levels=3),
        ransac=tconfig.RansacConfig(n_hyp=16),
        lm=tconfig.LMConfig(n_points=16, max_iters=5),
    )
    K = np.array([[110.0, 0, WS / 2], [0, 110.0, HS / 2], [0, 0, 1.0]])
    frames = list(photoreal.corridor_sequence(8, H=HS, W=WS, K=K, speed=0.45, seed=11)[0])
    return frames, cfg, 2  # 7 pairs: batches of 2, 2, 2 and 1


def _card_case():
    cam = tconfig.VOConfig().camera  # KITTI 00's P0 at 376x1241
    cfg = tconfig.VOConfig(ransac=tconfig.RansacConfig(n_hyp=512, method="lmeds"))
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    frames = list(photoreal.corridor_sequence(14, H=cam.height, W=cam.width, K=K,
                                              seed=3)[0])
    return frames, cfg, 4  # 13 pairs: batches of 4, 4, 4 and 1


_CASES = {}


def _case_of(device: str):
    """(frames, config, batch) of a device, made once per process."""
    if device not in _CASES:
        _CASES[device] = (_cpu_case if device == "cpu" else _card_case)()
    return _CASES[device]


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def case(request):
    """(device, frames, config, batch); the card's skips without one."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return (request.param, *_case_of(request.param))


def _step_by_step(frames, cfg, batch, seed, dev) -> runners.SequenceResult:
    """``run_vo_sequence``'s result from its batch step called one batch at
    a time, each batch's outputs fetched with ``.cpu()`` before the next."""
    step = runners._batched_vo(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dTs, n_trk, n_inl, rev, clouds, limits, total = [], [], [], [], [], [], 0
    for b0 in range(0, len(frames) - 1, batch):
        stack = torch.from_numpy(np.stack(frames[b0:b0 + batch + 1])).to(dev)
        head, cloud = step(stack[:-1], stack[1:], gen)
        h, c = head.cpu().numpy(), cloud.cpu().numpy()
        dTs.extend(h[:, :16].reshape(-1, 4, 4))
        n_trk.extend(h[:, 16].astype(np.int32))
        n_inl.extend(h[:, 17].astype(np.int32))
        rev.extend(h[:, 19] > 0.5)
        for cb in c:
            val = cb[:, 3] > 0.5
            clouds.append(cb[val, :3])
            limits.append(total)
            total += int(val.sum())
    return runners._finish(dTs, clouds, limits, n_inl, n_trk, rev, None,
                           profiling.MetricsLogger(None), None)


def _assert_same_result(a, b):
    for x, y in ((a.trajectory, b.trajectory), (a.cloud, b.cloud),
                 (a.cloud_limits, b.cloud_limits)):
        assert np.array_equal(x, y)
    for k in a.per_frame:
        assert np.array_equal(a.per_frame[k], b.per_frame[k]), k


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_run_vo_sequence_bit_equal_to_step_by_step(case, depth):
    device, frames, cfg, batch = case
    dev = torch.device(device)
    res = runners.run_vo_sequence(iter(frames), cfg, batch=batch, seed=5,
                                  pipeline_depth=depth, device=dev)
    _assert_same_result(res, _step_by_step(frames, cfg, batch, 5, dev))
    n_steps = -(-(len(frames) - 1) // batch)
    assert set(res.stats) == {"batches", "fetch_waited", "slot_waited"}
    assert res.stats["batches"] == n_steps
    assert 0 <= res.stats["fetch_waited"] <= n_steps
    assert 0 <= res.stats["slot_waited"] <= n_steps
    if device == "cpu":
        assert res.stats["fetch_waited"] == res.stats["slot_waited"] == 0


_EXTRACTED = {}


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_extract_pairs_bit_equal_across_depths(depth):
    frames, cfg, _ = _case_of("cpu")
    # Window pairs, none consecutive within a batch of 3: up to 6 frames a
    # slot, src and tgt gathered from the upload.
    pairs = [(1, 0), (1, 2), (0, 2), (2, 1), (2, 3), (1, 3), (3, 2), (3, 4), (2, 4), (4, 3)]

    def extract(d):
        stats = {}
        out = runners._extract_pairs(stream.FrameStream(frames), pairs, cfg, 0, n_points=8,
                                     batch=3, pipeline_depth=d, device="cpu", stats=stats)
        return out, stats

    if 1 not in _EXTRACTED:
        _EXTRACTED[1] = extract(1)
    (ref, _), (got, stats) = _EXTRACTED[1], extract(depth)
    assert set(got) == set(pairs) == set(ref)
    for pr in pairs:
        for k, v in got[pr].items():
            assert np.array_equal(v, ref[pr][k]), (pr, k)
    assert stats["fetch_waited"] == stats["slot_waited"] == 0


@pytest.mark.cuda
def test_ring_batch_makes_no_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, cfg, batch = _case_of("cuda")
    dev = torch.device("cuda")
    step = runners._batched_vo(cfg)
    ring = stream.TransferRing(dev, 3)
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(b0):
        slot, src, tgt = runners._pair_inputs(
            ring, frames.__getitem__, [(q, q + 1) for q in range(b0, b0 + batch)])
        head, _ = step(src, tgt, gen)
        ring.send(slot, head)
        return slot

    for b0 in range(3):  # the key's eager call, its capture, a replay; every slot used
        ring.fetch(one(b0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slot = one(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(ring.fetch(slot)).all()
    assert ring.stats["batches"] == 4
