"""Native streaming runtime: the real-time plumbing around the jitted XLA
compute path (ring buffers, FIFO framing, codec/proc status handshake, frame
clock) — counterpart of the reference's audio-callback infrastructure
(examples/src/matrixconv/matrixconv.c:117-151, _common.h:199-224)."""
from spatial_audio_framework_tpu.runtime.native import (  # noqa: F401
    CODEC_STATUS_INITIALISED,
    CODEC_STATUS_INITIALISING,
    CODEC_STATUS_NOT_INITIALISED,
    PROC_STATUS_NOT_ONGOING,
    PROC_STATUS_ONGOING,
    FifoFramer,
    FrameClock,
    RingBuffer,
    StatusFlags,
    native_available,
)
from spatial_audio_framework_tpu.runtime.stream import StreamRunner  # noqa: F401
from spatial_audio_framework_tpu.runtime.watchdog import Watchdog  # noqa: F401
