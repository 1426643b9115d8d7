"""Spans of the port's phases in a ``torch.profiler`` trace, at the cost of
one flag check where no profiler records.

:func:`span` is a ``torch.profiler.record_function`` while a profiler
records and a shared no-op context otherwise, so the spans land in the
trace that ``eval_drag --profile`` and the benchmark take, on the clock of
the device's events.  Span names start with ``dragposer.``; every host read
of a device value on the pipeline and anchor paths sits in a span whose
last name component is ``wait``.  The per-launch records that go with the
spans are ``_build.KernelCounts.log``: appended by
``KernelCounts.launched`` only while :func:`recording` is true, and
reduced by their reader after the run (:func:`counter_totals`).

The spans, outermost first:

* ``dragposer.pipeline``: ``drag/pipeline.run_batch_pipelined``; in it
  ``.prologue`` (the first frame's begin, the outputs' allocation),
  ``.wait`` (the first loop check), the blocks and ``.epilogue`` (the
  decode of the stored latents);
* ``dragposer.block``: one block; in it ``.k1`` (K1's launch, or the
  anchor's masked iterations), ``.finish`` (``finish``, the selects, the
  row writes), ``.begin`` (``begin_all`` and its selects), ``.targets``
  (``targets_all``, its selects, Adam's re-init) and ``.wait`` (the check
  of whether another block runs);
* ``dragposer.rollout``: ``engine._rollout_where_needed`` where K2 runs;
  ``dragposer.rollout.wait``: its ``nonzero`` of the lanes that need it;
* ``dragposer.to_host`` (``.wait``): ``engine.to_host``;
* ``dragposer.frame``: ``RealtimeSession.drag_pose``, one session frame;
  in it ``dragposer.frame.begin`` (``engine._begin_frame``, its check in
  ``.wait``), ``dragposer.anchor.step`` (one ``_opt_body`` and select)
  and ``dragposer.anchor.wait`` (the stop rule's check) an iteration,
  ``dragposer.frame.finish`` (``engine._finish_frame``) and
  ``dragposer.frame.reply`` (``step_realtime``'s FK; ``drag_pose``'s
  copies, in ``.wait``).
"""

from __future__ import annotations

import contextlib

import torch

# whether a profiler records in this process (a C call, well under 1 us)
recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    no-op context."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


def counter_totals() -> dict:
    """The launch records' totals (a host read of each record's tensors):
    K1's launches, lane-steps taken and lanes × each launch's longest lane;
    K2's launches and lanes run; the rollouts' lanes run and the lanes
    among them that began a real frame (within the lane's length)."""
    from dragposer_tpu_torch import _build

    k1 = _build.launch_log("K1", "K1_general")
    steps = [r["t1"].long() - r["t0"].long() for r in k1]
    k2 = _build.launch_log("K2")
    rollouts = _build.launch_log("rollout")
    return {
        "k1_launches": len(k1),
        "k1_lane_steps": int(sum(int(s.sum()) for s in steps)),
        "k1_lane_steps_issued": int(sum(int(s.max()) * s.numel()
                                        for s in steps)),
        "k2_launches": len(k2),
        "k2_lanes": sum(r["lanes"] for r in k2),
        "rollout_lanes": sum(r["lanes"] for r in rollouts),
        "rollout_needed_lanes": int(sum(int(needed_lanes(r))
                                        for r in rollouts)),
    }


def needed_lanes(record: dict):
    """The lanes of a rollout record that began a real frame: its ``need``
    mask, within each lane's length where the record holds ``frame`` and
    ``limit`` (a 0-d tensor; a device value)."""
    need = record["need"]
    if record.get("frame") is not None:
        need = need & (record["frame"] < record["limit"])
    return need.sum()
