"""Host-side video I/O of the port (OpenCV videoio, threaded)."""

from rrin_tpu_torch.io.video import VideoMeta, VideoReader, VideoWriter, probe_video

__all__ = ["VideoMeta", "VideoReader", "VideoWriter", "probe_video"]
