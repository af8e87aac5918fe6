"""OpenCV-based video decode/encode with threaded prefetch.

Decode runs on a background thread pushing into a bounded queue so host
decode overlaps device compute; encode runs on its own thread likewise.

Frames cross these APIs as RGB uint8 HWC numpy arrays by default; the
streaming pipeline opts into raw-BGR mode on both ends so original frames
pass through with no swap and the one needed swap (device input) fuses into
the native pair packer.

``cv2`` is imported inside the functions that need it, so the package and
the model path import and run on a machine without OpenCV.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from rrin_tpu_torch import native


def _swap_rb(frame: np.ndarray) -> np.ndarray:
    """BGR <-> RGB as a contiguous copy (the native swap; numpy without it)."""
    return native.swap_rb(frame)


@dataclass
class VideoMeta:
    width: int
    height: int
    fps: float
    frame_count: int  # may be 0/negative if the container lies
    fps_assumed: bool = False  # container had no fps metadata; 30.0 default


def probe_video(path: str) -> VideoMeta:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    raw_fps = float(cap.get(cv2.CAP_PROP_FPS))
    meta = VideoMeta(
        width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        fps=raw_fps or 30.0,
        frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        fps_assumed=not raw_fps,
    )
    cap.release()
    return meta


class VideoReader:
    """Threaded sequential decoder yielding uint8 HWC frames.

    ``rgb=True`` (default) swaps OpenCV's BGR to RGB on the decode thread.
    The streaming pipeline passes ``rgb=False`` and swaps while it packs
    the pair batch instead (one fewer full pass per frame).
    """

    _SENTINEL = None

    def __init__(self, path: str, queue_depth: int = 8, start_frame: int = 0,
                 rgb: bool = True):
        import cv2

        self._rgb = rgb
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        if start_frame:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
        raw_fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self.meta = VideoMeta(
            width=int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=raw_fps or 30.0,
            frame_count=int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            fps_assumed=not raw_fps,
        )
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=queue_depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._decode_loop, daemon=True)
        self._thread.start()

    def _decode_loop(self) -> None:
        try:
            while not self._stop.is_set():
                ok, frame = self._cap.read()
                if not ok:
                    break
                frame = np.ascontiguousarray(frame)
                rgb = _swap_rb(frame) if self._rgb else frame
                while not self._stop.is_set():
                    try:
                        self._q.put(rgb, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
        finally:
            self._cap.release()
            try:
                self._q.put(self._SENTINEL, timeout=5.0)
            except queue.Full:
                pass

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self._q.get()
            if frame is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield frame

    def close(self) -> None:
        self._stop.set()
        # Drain until the thread exits: the producer can re-fill the queue
        # after a single drain (it blocks on put for at most 0.1s before
        # re-checking the stop flag), so drain+join in a loop.
        deadline = time.monotonic() + 10.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)


class VideoWriter:
    """Threaded encoder consuming RGB uint8 HWC frames.

    Encode runs on its own thread so ``write`` never blocks device dispatch;
    ``frames_written`` is the resume watermark of a video job.
    """

    _SENTINEL = None

    def __init__(
        self,
        path: str,
        fps: float,
        size_hw: Tuple[int, int],
        fourcc: str = "mp4v",
        queue_depth: int = 16,
        input_rgb: bool = True,
    ):
        import cv2

        self._input_rgb = input_rgb
        h, w = size_hw
        self._writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h)
        )
        if not self._writer.isOpened():
            raise IOError(f"cannot open encoder for {path} ({fourcc} {w}x{h}@{fps})")
        self.path = path
        self.frames_written = 0
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=queue_depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._encode_loop, daemon=True)
        self._thread.start()

    def _encode_loop(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    break
                frame, rgb = item
                self._writer.write(_swap_rb(frame) if rgb else frame)
                self.frames_written += 1
        except BaseException as e:
            self._err = e
            # Unblock any producer waiting on a full queue; write()/close()
            # re-check _err between put attempts and surface it.
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        finally:
            self._writer.release()

    def _put_checked(self, item) -> None:
        """put() that can never deadlock on a dead/erroring encoder thread."""
        while True:
            if self._err is not None:
                raise self._err
            if not self._thread.is_alive():
                raise IOError(f"encoder thread for {self.path} exited")
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def write(self, frame: np.ndarray, rgb: Optional[bool] = None) -> None:
        """Queue a frame; ``rgb`` overrides the constructor's input_rgb
        per call (the pipeline writes BGR originals and RGB device output
        through one writer — the swap runs on the encode thread)."""
        rgb = self._input_rgb if rgb is None else rgb
        self._put_checked((frame, rgb))

    def close(self) -> None:
        try:
            self._put_checked(self._SENTINEL)
        except IOError:
            pass  # thread already gone; fall through to surface _err
        self._thread.join()
        if self._err is not None:
            raise self._err
