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
  anchor's masked iterations), then the bookkeeping: eager, ``.finish``
  (the advance, the selects, the row writes) and ``.targets`` (the next
  frame's targets, their selects, Adam's re-init, the lanes still
  active), or on the card ``.graph`` (one replay of the block's CUDA
  graph of both); then ``.begin`` (the rollout and its selects) and
  ``.wait`` (the count of active lanes: whether another block runs, and
  on how many lanes its rollout may run);
* ``dragposer.rollout``: ``engine._rollout_where_needed`` where K2 runs;
  ``dragposer.rollout.wait``: at a window, its count of the lanes that
  need it;
* ``dragposer.to_host``: ``engine.to_host``; in it, on the card,
  ``.wait`` (each lane's prefix that holds data, read to the host),
  ``.pack`` (the prefixes gathered on the card) and ``.fill`` (the packed
  rows through the pinned ring into the host's arrays); elsewhere
  ``.wait`` alone;
* ``dragposer.beam``: ``hypotheses.run_hypotheses_batched``; in it, a
  chunk, ``.chunk`` (its inputs copied into the chunk buffers and its
  ``dragposer.pipeline``) then ``.select`` (its scores to the next
  chunk's states), and last ``.emit`` (the winners' back-trace and their
  ``dragposer.to_host``);
* ``dragposer.frame``: ``RealtimeSession.drag_pose``, one session frame;
  in it ``dragposer.frame.begin`` (``engine._begin_frame``, its check in
  ``.wait``), ``dragposer.anchor.step`` (one ``_opt_body`` and select,
  or on the card one replay of the anchor's graph) and
  ``dragposer.anchor.wait`` (the stop rule's check) an iteration,
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
    among them that began a real frame (within the lane's length); the
    anchor's iterations, those that were graph replays and the captures;
    the pipeline's blocks, those replayed as its graph and the captures;
    the rows of the outputs copied to the host and those kept (each
    lane's prefix that holds data)."""
    from dragposer_tpu_torch import _build

    k1 = _build.launch_log("K1", "K1_general")
    steps = [r["t1"].long() - r["t0"].long() for r in k1]
    k2 = _build.launch_log("K2")
    rollouts = _build.launch_log("rollout")
    anchor = _build.launch_log("anchor")
    blocks = _build.launch_log("block")
    copies = _build.launch_log("to_host")
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
        "anchor_iterations": len(anchor),
        "anchor_graph_replays": sum(not r["plain"] for r in anchor),
        "anchor_graph_captures": sum(r["capture"] for r in anchor),
        "pipeline_blocks": len(blocks),
        "pipeline_graph_replays": sum(not r["plain"] for r in blocks),
        "pipeline_graph_captures": sum(r["capture"] for r in blocks),
        "to_host_rows": sum(r["rows"] for r in copies),
        "to_host_kept_rows": sum(r["kept"] for r in copies),
    }


def needed_lanes(record: dict):
    """The lanes of a rollout record that began a real frame: its ``need``
    mask, within each lane's length where the record holds ``frame`` and
    ``limit`` (a 0-d tensor; a device value)."""
    need = record["need"]
    if record.get("frame") is not None:
        need = need & (record["frame"] < record["limit"])
    return need.sum()
