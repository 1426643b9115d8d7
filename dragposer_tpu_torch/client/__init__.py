"""Client layer: the reference Unity client's capabilities as a library
(port of ``dragposer_tpu/client``: its numpy modules copied,
``ClientDragPoser`` on this package's realtime session).

* :mod:`client.math` — smoothing, damping, continuity, LH/RH + xyzw/wxyz
  conversions (``Core/DragPoser.cs``, ``Utils/MathExtensions.cs``);
* :mod:`client.retarget` — T-pose tracker retargeting
  (``Core/TrackerRetargeter.cs``);
* :mod:`client.driver` — the per-frame client pipeline (``Core/DragPoser.cs``);
* :mod:`client.playback` — BVH-driven trackers (``BVH/BVHPlayback.cs``);
* :mod:`client.vr` — VR device detection, role identification and VRIK
  calibration behind a device-provider protocol (the SteamVR layer);
* ``client/viewer.html`` — the browser viewer ``cli/interactive`` serves.
"""

from dragposer_tpu_torch.client import math  # noqa: F401
