"""Client layer: the reference Unity client's capabilities as a library
(port of ``dragposer_tpu/client``: its numpy modules copied,
``ClientDragPoser`` on this package's realtime session).

* :mod:`client.math` — smoothing, damping, continuity, LH/RH + xyzw/wxyz
  conversions (``Core/DragPoser.cs``, ``Utils/MathExtensions.cs``);
* :mod:`client.retarget` — T-pose tracker retargeting
  (``Core/TrackerRetargeter.cs``);
* :mod:`client.driver` — the per-frame client pipeline (``Core/DragPoser.cs``);

The JAX package's ``client.playback``, ``client.vr``, ``cli/interactive``
and ``cli/visualize`` are not ported yet.
"""

from dragposer_tpu_torch.client import math  # noqa: F401
