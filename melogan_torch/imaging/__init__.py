"""Self-contained image ops (no cv2/PIL in the production path).

The port's copy of ``melogan_tpu/imaging``:

- ``jpeg``: baseline JFIF encoder (the reference streams webcam frames as
  JPEG via ``cv2.imencode('.jpg', frame)``, camera/camera.py:117-121), with
  its native twin in ``native``
- ``draw``: rectangle/text annotation primitives (the reference's
  ``cv2.rectangle``/``cv2.putText`` overlay, camera/camera.py:104-110)
- ``y4m``: YUV4MPEG2 video in and out, the ``/video_feed`` file source
"""

from melogan_torch.imaging.draw import draw_rect, draw_text
from melogan_torch.imaging.jpeg import encode_jpeg

__all__ = ["encode_jpeg", "draw_rect", "draw_text"]
