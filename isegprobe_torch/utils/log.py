"""Run logs: the package logger's file handlers, the window-averaged
TensorBoard scalars and the optional wandb run.

Counterpart of ``isegprobe_tpu/utils/log.py`` (``add_logging``,
``TqdmToLogger``, ``SummaryWriterAvg``, ``init_wandb``). The JAX package
writes its scalars through tensorboardX; the GPU machine has neither
tensorboardX nor tensorboard, so :class:`EventFileWriter` writes the event
file itself: TFRecord framing (little-endian length, masked CRC-32C of the
length, the record, masked CRC-32C of the record), a first event with
``file_version: "brain.Event:2"``, then one ``Event{wall_time, step,
summary: Summary{value: [Value{tag, simple_value}]}}`` a scalar, in
tensorboardX's file name ``events.out.tfevents.<10-digit time>.<host>``.
TensorBoard reads it as it reads tensorboardX's; :func:`read_scalars` reads
either back without TensorBoard.
"""

from __future__ import annotations

import io
import logging
import socket
import struct
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["logger", "add_logging", "TqdmToLogger", "EventFileWriter",
           "SummaryWriterAvg", "read_events", "read_scalars", "init_wandb",
           "crc32c"]

logger = logging.getLogger("isegprobe_torch")


def add_logging(logs_path, prefix: str = "") -> None:
    """A file handler on the package logger: ``<logs_path>/<prefix><date
    and time>.log``."""
    logs_path = Path(logs_path)
    logs_path.mkdir(parents=True, exist_ok=True)
    log_name = prefix + datetime.strftime(datetime.today(),
                                          "%Y-%m-%d_%H-%M-%S") + ".log"
    fh = logging.FileHandler(logs_path / log_name)
    fh.setFormatter(logging.Formatter(
        "(%(levelname)s) %(asctime)s: %(message)s",
        datefmt="%d-%m-%y %H:%M:%S"))
    logger.addHandler(fh)


class TqdmToLogger(io.StringIO):
    """A tqdm output stream that logs its last line at most every
    ``mininterval`` seconds."""

    def __init__(self, logger_, level=logging.INFO, mininterval=5):
        super().__init__()
        self.logger = logger_
        self.level = level
        self.mininterval = mininterval
        self.last_time = 0
        self.buf = ""

    def write(self, buf):
        self.buf = buf.strip("\r\n\t ")

    def flush(self):
        if len(self.buf) > 0 and time.time() - self.last_time > \
                self.mininterval:
            self.logger.log(self.level, self.buf)
            self.last_time = time.time()


# -- the event file -----------------------------------------------------------

def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _event(wall_time: float, step: int = 0, file_version: str = None,
           summary: bytes = None) -> bytes:
    """An ``Event`` message (proto3: a zero step is not written)."""
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _field(2, 0) + _varint(int(step))
    if file_version is not None:
        v = file_version.encode()
        out += _field(3, 2) + _varint(len(v)) + v
    if summary is not None:
        out += _field(5, 2) + _varint(len(summary)) + summary
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    t = tag.encode()
    val = (_field(1, 2) + _varint(len(t)) + t + _field(2, 5)
           + struct.pack("<f", value))
    return _field(1, 2) + _varint(len(val)) + val


class EventFileWriter:
    """Scalars into a TensorBoard event file in ``log_dir``, written on the
    calling thread and flushed every ``flush_secs`` seconds and on
    :meth:`close`."""

    def __init__(self, log_dir, flush_secs: int = 10) -> None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / ("events.out.tfevents." + str(time.time())[:10]
                               + "." + socket.gethostname())
        self._f = open(self.path, "ab")
        self._flush_secs = flush_secs
        self._last_flush = time.time()
        self._write(_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + record + struct.pack("<I", _masked_crc(record)))
        if time.time() - self._last_flush > self._flush_secs:
            self.flush()

    def add_scalar(self, tag: str, value, global_step: int = None,
                   walltime: float = None) -> None:
        self._write(_event(time.time() if walltime is None else walltime,
                           0 if global_step is None else int(global_step),
                           summary=_scalar_summary(tag, float(value))))

    def flush(self) -> None:
        self._f.flush()
        self._last_flush = time.time()

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()


class SummaryWriterAvg:
    """TensorBoard scalars averaged over windows of ``dump_period`` values
    a tag (one point at the window's last step), through
    :class:`EventFileWriter`; ``disable_avg`` writes a value as it is."""

    def __init__(self, log_dir, flush_secs: int = 10,
                 dump_period: int = 20) -> None:
        self._writer = EventFileWriter(log_dir, flush_secs=flush_secs)
        self._dump_period = dump_period
        self._avg_scalars: Dict[str, _ScalarAccumulator] = {}

    def add_scalar(self, tag, value, global_step, disable_avg: bool = False):
        if disable_avg or isinstance(value, (tuple, list, dict)):
            self._writer.add_scalar(tag, value, global_step=global_step)
            return
        if tag not in self._avg_scalars:
            self._avg_scalars[tag] = _ScalarAccumulator(self._dump_period)
        avg_scalar = self._avg_scalars[tag]
        avg_scalar.add(value)
        if avg_scalar.is_full():
            self._writer.add_scalar(tag, avg_scalar.value,
                                    global_step=global_step)
            avg_scalar.reset()

    def close(self) -> None:
        self._writer.close()


class _ScalarAccumulator:
    def __init__(self, period: int):
        self.sum = 0.0
        self.cnt = 0
        self.period = period

    def add(self, value) -> None:
        self.sum += float(value)
        self.cnt += 1

    @property
    def value(self) -> float:
        return self.sum / self.cnt if self.cnt > 0 else 0.0

    def reset(self) -> None:
        self.cnt = 0
        self.sum = 0.0

    def is_full(self) -> bool:
        return self.cnt >= self.period


# -- reading it back -------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of a message: ints for varints,
    bytes for the rest."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")
        yield num, wire, value


def read_events(path) -> List[Dict]:
    """The events of one event file: ``{"wall_time", "step",
    "file_version"}`` or ``{"wall_time", "step", "values": [(tag,
    float32 value)]}``, each record's CRCs checked."""
    data = Path(path).read_bytes()
    events, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        record = data[pos + 12:pos + 12 + n]
        (rcrc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if hcrc != _masked_crc(header) or rcrc != _masked_crc(record):
            raise ValueError(f"{path}: record at byte {pos} fails its CRC")
        pos += 16 + n
        event = {"wall_time": 0.0, "step": 0}
        for num, _, value in _fields(record):
            if num == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif num == 2:
                event["step"] = value - (1 << 64) if value >> 63 else value
            elif num == 3:
                event["file_version"] = value.decode()
            elif num == 5:
                vals = []
                for vnum, _, v in _fields(value):
                    if vnum != 1:
                        continue
                    tag, simple = None, None
                    for fnum, _, f in _fields(v):
                        if fnum == 1:
                            tag = f.decode()
                        elif fnum == 2:
                            simple = struct.unpack("<f", f)[0]
                    if simple is not None:
                        vals.append((tag, simple))
                event["values"] = vals
        events.append(event)
    return events


def read_scalars(log_dir) -> Dict[str, List[Tuple[int, float]]]:
    """Every scalar of the event files in ``log_dir``: tag -> [(step,
    float32 value)] in file and write order."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for path in sorted(Path(log_dir).glob("events.out.tfevents.*")):
        for event in read_events(path):
            for tag, value in event.get("values", ()):
                out.setdefault(tag, []).append((event["step"], value))
    return out


# -- wandb -------------------------------------------------------------------------

def init_wandb(cfg: Dict, logs_path) -> bool:
    """The optional W&B run of a training run, as the JAX package starts
    it: nothing unless ``wandb.log_wandb``; with it, a warning and nothing
    when ``wandb`` cannot be imported, else ``wandb.tensorboard.patch(
    root_logdir=logs_path)`` and ``wandb.init(project, name, dir,
    sync_tensorboard=True)`` from the ``wandb.*`` keys. Returns whether a
    run was started."""
    if not cfg.get("wandb.log_wandb", False):
        return False
    try:
        import wandb
    except ImportError:
        logger.warning("wandb requested but not installed; skipping")
        return False
    wandb.tensorboard.patch(root_logdir=str(logs_path))
    wandb.init(project=cfg.get("wandb.project") or "iSegProbe-Train",
               name=cfg.get("wandb.name") or None,
               dir=cfg.get("wandb.dir") or None, sync_tensorboard=True)
    return True
