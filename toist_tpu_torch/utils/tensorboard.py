"""Dependency-free TensorBoard scalar writer (tfevents format).

The reference logs per-step losses, cluster-bank telemetry, and per-epoch mAP
to TensorBoard (torch SummaryWriter: main.py:593,697-711, engine.py:108-111,
190-193,242-245). This image ships neither tensorflow nor tensorboard, so this
module emits the event-file format directly: TFRecord framing (length +
masked-CRC32C checksums) around hand-encoded `tensorflow.Event` protobuf
messages carrying `Summary.Value{tag, simple_value}` scalars. Any stock
TensorBoard install reads the output; tests decode it back with an independent
parser (tests/test_tensorboard.py).

The port's own copy of ``toist_tpu/utils/tensorboard.py``, line for line but
for the rank gate, which asks ``torch.distributed`` (``utils/dist.py``).

Format references (public specs):
  * TFRecord: [u64 length][u32 masked_crc32c(len)][data][u32 masked_crc32c(data)]
    with mask(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32.
  * Event proto: wall_time=1 (double), step=2 (int64), file_version=3 (string),
    summary=5 (message); Summary: value=1 (repeated); Value: tag=1 (string),
    simple_value=2 (float).
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------- CRC32C ----

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    """Castagnoli CRC-32 (poly 0x1EDC6F41 reflected)."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding --

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def encode_scalar_event(wall_time: float, step: int,
                        scalars: Dict[str, float]) -> bytes:
    """Event{wall_time, step, summary{value+: {tag, simple_value}}}."""
    summary = b"".join(
        _bytes(1, _bytes(1, tag.encode()) + _float(2, float(val)))
        for tag, val in scalars.items())
    return _double(1, wall_time) + _int64(2, step) + _bytes(5, summary)


def encode_version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _bytes(3, b"brain.Event:2")


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header)) + data
            + struct.pack("<I", _masked_crc(data)))


# --------------------------------------------------------------- writer -----

class SummaryWriter:
    """Scalar-only TensorBoard writer (the slice the reference uses).

    Rank-gated like the reference's (created under is_main_process,
    main.py:592-593): non-zero hosts get a no-op writer. Records are appended
    and flushed per add_scalars call — epoch cadence is coarse enough that
    buffering would only risk losing records on the NaN hard-stop.
    """

    def __init__(self, logdir: Optional[str], rank_gated: bool = True):
        self.path = None
        if not logdir:
            return
        if rank_gated:
            from toist_tpu_torch.utils.dist import process_index
            if process_index() != 0:
                return
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        with open(self.path, "ab") as f:
            f.write(tfrecord(encode_version_event(time.time())))

    def add_scalars(self, scalars: Dict[str, float], step: int):
        if not self.path or not scalars:
            return
        rec = tfrecord(encode_scalar_event(time.time(), int(step), scalars))
        with open(self.path, "ab") as f:
            f.write(rec)

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars({tag: value}, step)
