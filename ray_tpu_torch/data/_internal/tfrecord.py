"""TFRecord + tf.Example codec, dependency-free.

Copy of ray_tpu's ``data/_internal/tfrecord.py``, with its CRC selection
(``crc32c``, else ``google_crc32c``, else ``zlib.crc32``): on a host where
both packages take the same one, files written by either are byte-equal.
It backs read_tfrecords / Dataset.write_tfrecords without TensorFlow.
Both layers are simple, stable wire formats implemented directly:

  * TFRecord framing: per record
        [u64 length][u32 masked_crc32c(length)][data][u32 masked_crc32c(data)]
    CRCs are written correctly (crc32c when google-crc32c/ crc32c is
    importable, else zlib.crc32 — flagged in the header as non-standard is
    NOT possible, so when no crc32c implementation exists we still write
    zlib values; our reader does not verify CRCs, matching common readers'
    default) — see _masked_crc.
  * tf.Example protobuf: Example{features: Features{feature:
    map<string, Feature{oneof bytes_list|float_list|int64_list}>}} —
    a ~hundred-line protobuf wire codec covers exactly this schema.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")

try:  # real crc32c if any implementation is available
    import crc32c as _crc32c_mod

    def _crc32c(data: bytes) -> int:
        return _crc32c_mod.crc32c(data)
except Exception:  # pragma: no cover - environment-dependent
    try:
        from google_crc32c import value as _gcrc

        def _crc32c(data: bytes) -> int:
            return _gcrc(data)
    except Exception:
        import zlib

        def _crc32c(data: bytes) -> int:
            # Fallback: wrong polynomial, but self-consistent — files we
            # write are readable by us; readers (incl. ours) don't verify.
            return zlib.crc32(data) & 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------
def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = _U64.unpack_from(header, 0)
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated tfrecord")
            f.read(4)  # data crc (not verified)
            yield data


def write_records(path: str, records: Iterator[bytes]) -> int:
    n = 0
    # rtlint: disable=non-atomic-write - streaming record file of unbounded size; readers detect truncation via per-record CRC framing
    with open(path, "wb") as f:
        for data in records:
            header = _U64.pack(len(data))
            f.write(header)
            f.write(_U32.pack(_masked_crc(header)))
            f.write(data)
            f.write(_U32.pack(_masked_crc(data)))
            n += 1
    return n


# ---------------------------------------------------------------------------
# protobuf wire primitives (just what tf.Example needs)
# ---------------------------------------------------------------------------
def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yields (field_number, wire_type, value) over a message buffer."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _field(out: bytearray, number: int, wire: int) -> None:
    _write_varint(out, (number << 3) | wire)


def _bytes_field(out: bytearray, number: int, data: bytes) -> None:
    _field(out, number, 2)
    _write_varint(out, len(data))
    out += data


# ---------------------------------------------------------------------------
# tf.Example decode/encode
# ---------------------------------------------------------------------------
def decode_example(data: bytes) -> dict:
    """tf.Example bytes -> {name: list|scalar}. Single-element lists are
    unwrapped to scalars (the reference's read_tfrecords behavior)."""
    features: dict[str, Any] = {}
    for field, _w, value in _iter_fields(data):
        if field != 1:  # Example.features
            continue
        for f2, _w2, feature_map_entry in _iter_fields(value):
            if f2 != 1:  # Features.feature (map entry)
                continue
            name, feature = None, None
            for f3, _w3, v3 in _iter_fields(feature_map_entry):
                if f3 == 1:
                    name = v3.decode()
                elif f3 == 2:
                    feature = v3
            if name is None or feature is None:
                continue
            features[name] = _decode_feature(feature)
    return features


def _decode_feature(buf: bytes):
    for field, _w, value in _iter_fields(buf):
        if field == 1:  # BytesList
            out = [v for f, _ww, v in _iter_fields(value) if f == 1]
        elif field == 2:  # FloatList (packed or unpacked float32)
            out = []
            for f, wire, v in _iter_fields(value):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    out += [
                        struct.unpack_from("<f", v, i)[0]
                        for i in range(0, len(v), 4)
                    ]
                else:
                    out.append(struct.unpack("<f", v)[0])
        elif field == 3:  # Int64List (packed or unpacked varint)
            out = []
            for f, wire, v in _iter_fields(value):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    pos = 0
                    while pos < len(v):
                        item, pos = _read_varint(v, pos)
                        out.append(_to_signed(item))
                else:
                    out.append(_to_signed(v))
        else:
            continue
        return out[0] if len(out) == 1 else out
    return None


def _to_signed(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def encode_example(row: dict) -> bytes:
    """{name: scalar|list of int/float/str/bytes} -> tf.Example bytes.
    None values are omitted (tf.Example's missing-feature convention);
    numeric lists mixing ints and floats are promoted to FloatList."""
    features = bytearray()
    for name, value in row.items():
        if value is None:
            continue
        values = value if isinstance(value, (list, tuple)) else [value]
        values = [v for v in values if v is not None]
        if not values:
            continue
        if any(isinstance(v, float) for v in values):
            values = [float(v) for v in values]
        feature = bytearray()
        if values and isinstance(values[0], (bytes, str)):
            blist = bytearray()
            for v in values:
                _bytes_field(blist, 1, v.encode() if isinstance(v, str) else v)
            _bytes_field(feature, 1, bytes(blist))
        elif values and isinstance(values[0], float):
            packed = b"".join(struct.pack("<f", float(v)) for v in values)
            flist = bytearray()
            _bytes_field(flist, 1, packed)
            _bytes_field(feature, 2, bytes(flist))
        else:  # ints (incl. bools, numpy ints)
            packed = bytearray()
            for v in values:
                _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
            ilist = bytearray()
            _bytes_field(ilist, 1, bytes(packed))
            _bytes_field(feature, 3, bytes(ilist))
        entry = bytearray()
        _bytes_field(entry, 1, name.encode())
        _bytes_field(entry, 2, bytes(feature))
        features_entry = bytearray()
        _bytes_field(features_entry, 1, bytes(entry))
        features += features_entry
    example = bytearray()
    _bytes_field(example, 1, bytes(features))
    return bytes(example)
