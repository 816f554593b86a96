"""StreamRunner — the executor tying the native runtime plumbing to a jitted
per-frame process function.

Mirrors the reference's plugin lifecycle (create/initCodec/process,
examples/include/_common.h): arbitrary host block sizes are FIFO-framed to the
model's fixed frame size (matrixconv.c:117-151), a (re)initialisation thread
coordinates with the audio path through the CODEC/PROC status handshake
(ambi_bin.c:180-186), silence is emitted while the codec initialises
(ambi_bin.c:475-477), and a frame clock tracks the achieved real-time factor.

Optionally runs decoupled: `start()` spawns a render thread fed by lock-free
ring buffers, so a real audio callback only ever touches rb_write/rb_read —
the device dispatch happens on the render thread.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from spatial_audio_framework_tpu.runtime.native import (FifoFramer, FrameClock,
                                                        RingBuffer, StatusFlags)


class StreamRunner:
    def __init__(self, process_frame: Callable[[np.ndarray], np.ndarray],
                 n_ch_in: int, n_ch_out: int, frame_size: int = 128,
                 fs: float = 48000.0, ring_frames: int = 64):
        """process_frame: (n_ch_in, frame_size) float32 -> (n_ch_out,
        frame_size); typically closes over jitted model state and updates it."""
        self.process_frame = process_frame
        self.n_ch_in, self.n_ch_out = n_ch_in, n_ch_out
        self.frame_size = frame_size
        self.status = StatusFlags()
        self.clock = FrameClock(fs, frame_size)
        self._framer = FifoFramer(max(n_ch_in, n_ch_out), frame_size)
        self._in_rb = RingBuffer(ring_frames * n_ch_in * frame_size)
        self._out_rb = RingBuffer(ring_frames * n_ch_out * frame_size)
        self._render_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.status.end_init()  # codec ready once process_frame is supplied

    # -- codec re-initialisation ---------------------------------------------

    def reinit(self, init_fn: Callable[[], Callable[[np.ndarray], np.ndarray]],
               timeout_ms: int = 10000) -> bool:
        """Swap the process function without racing the audio path
        (the initCodec handshake)."""
        if not self.status.begin_init(timeout_ms):
            return False
        try:
            self.process_frame = init_fn()
        finally:
            self.status.end_init()
        return True

    # -- synchronous (in-callback) path --------------------------------------

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """x: (n_ch_in, nSamples), any nSamples → (n_ch_out, nSamples) with
        frame_size samples of FIFO latency."""
        x = np.asarray(x, np.float32)
        pad = np.zeros((self._framer.n_ch, x.shape[1]), np.float32)
        pad[:self.n_ch_in] = x

        def run(f):
            y = np.zeros((self._framer.n_ch, self.frame_size), np.float32)
            if self.status.try_begin_process():
                try:
                    y[:self.n_ch_out] = np.asarray(
                        self.process_frame(f[:self.n_ch_in]), np.float32)
                finally:
                    self.status.end_process()
            self.clock.tick(1)
            return y

        out = self._framer.push_chunked(pad, run)
        return out[:self.n_ch_out]

    # -- decoupled render-thread path ----------------------------------------

    def start(self):
        """Spawn the render thread (audio callback then uses push/pull)."""
        if self._render_thread is not None:
            return
        self._stop.clear()
        self._render_thread = threading.Thread(target=self._render_loop,
                                               daemon=True)
        self._render_thread.start()

    def stop(self):
        self._stop.set()
        if self._render_thread is not None:
            self._render_thread.join()
            self._render_thread = None

    def push(self, x: np.ndarray) -> int:
        """Audio-callback producer: (n_ch_in, n) samples into the input ring.
        Returns samples accepted (never blocks)."""
        x = np.ascontiguousarray(x, np.float32)
        return self._in_rb.write(x.T) // self.n_ch_in  # interleaved frames

    def pull(self, n: int) -> np.ndarray:
        """Audio-callback consumer: up to n samples from the output ring →
        (n_ch_out, m)."""
        flat = self._out_rb.read(n * self.n_ch_out, partial=True)
        m = flat.size // self.n_ch_out
        return flat[:m * self.n_ch_out].reshape(m, self.n_ch_out).T

    def _render_loop(self):
        need = self.frame_size * self.n_ch_in
        while not self._stop.is_set():
            if self._in_rb.readable < need:
                self._stop.wait(0.0005)
                continue
            frame = self._in_rb.read(need).reshape(self.frame_size,
                                                   self.n_ch_in).T
            y = np.zeros((self.n_ch_out, self.frame_size), np.float32)
            if self.status.try_begin_process():
                try:
                    y = np.asarray(self.process_frame(frame), np.float32)
                finally:
                    self.status.end_process()
            self._out_rb.write(np.ascontiguousarray(y.T))
            self.clock.tick(1)
