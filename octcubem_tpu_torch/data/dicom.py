"""Minimal DICOM reader and writer (counterpart of
octcubem_tpu/data/dicom.py; the port keeps its own copy, pure Python:
``struct`` and numpy, no pydicom).

Reads uncompressed little-endian transfer syntaxes (implicit and
explicit VR), which covers the OCT volume exports the reference pipeline
consumes (a ``.dcm`` -> ``pixel_array`` [frames, rows, cols]).  The
writer makes synthetic multiframe volumes for tests and smoke runs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL", b"UC", b"UR"}

TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_FRAMES = (0x0028, 0x0008)
TAG_BITS_ALLOC = (0x0028, 0x0100)
TAG_PIXEL_REP = (0x0028, 0x0103)
TAG_PIXELDATA = (0x7FE0, 0x0010)
TAG_MANUFACTURER = (0x0008, 0x0070)
TAG_MODEL = (0x0008, 0x1090)


@dataclass
class DicomFile:
    elements: dict = field(default_factory=dict)

    def get(self, tag, default=None):
        return self.elements.get(tag, default)

    @property
    def manufacturer(self) -> str:
        v = self.get(TAG_MANUFACTURER, b"")
        return v.decode("ascii", "replace").strip() if isinstance(v, bytes) else str(v)

    @property
    def model_name(self) -> str:
        v = self.get(TAG_MODEL, b"")
        return v.decode("ascii", "replace").strip() if isinstance(v, bytes) else str(v)

    @property
    def pixel_array(self) -> np.ndarray:
        rows = int(self.get(TAG_ROWS))
        cols = int(self.get(TAG_COLS))
        frames_raw = self.get(TAG_FRAMES, b"1")
        if isinstance(frames_raw, bytes):
            frames_raw = frames_raw.decode("ascii", "replace").strip("\x00 ")
        frames = int(frames_raw)
        bits = int(self.get(TAG_BITS_ALLOC, 8))
        dtype = {8: np.uint8, 16: np.uint16}[bits]
        raw = self.get(TAG_PIXELDATA)
        arr = np.frombuffer(raw, dtype=dtype, count=frames * rows * cols)
        shape = (frames, rows, cols) if frames > 1 else (rows, cols)
        return arr.reshape(shape)


def _parse_int_like(vr: bytes, data: bytes):
    if vr in (b"US",):
        return struct.unpack("<H", data[:2])[0]
    if vr in (b"UL",):
        return struct.unpack("<I", data[:4])[0]
    if vr in (b"SS",):
        return struct.unpack("<h", data[:2])[0]
    if vr == b"UN":
        # implicit-VR little-endian: the numeric geometry tags (US/UL in
        # the standard) arrive as raw 2-/4-byte binary values with no VR
        # marker — decode by length (this helper is only applied to the
        # known integer tags, see read_dicom)
        if len(data) == 2:
            return struct.unpack("<H", data)[0]
        if len(data) == 4:
            return struct.unpack("<I", data)[0]
    return data


def read_dicom(path: str) -> DicomFile:
    with open(path, "rb") as f:
        data = f.read()
    if data[128:132] != b"DICM":
        raise ValueError(f"{path}: not a DICOM part-10 file")
    pos = 132
    out = DicomFile()
    explicit = True  # meta group is always explicit; dataset syntax checked below
    transfer_syntax = None
    n = len(data)
    while pos + 8 <= n:
        group, elem = struct.unpack("<HH", data[pos:pos + 4])
        tag = (group, elem)
        if group != 0x0002 and transfer_syntax is not None and explicit is None:
            pass
        if explicit or group == 0x0002:
            vr = data[pos + 4:pos + 6]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack("<I", data[pos + 8:pos + 12])[0]
                hdr = 12
            elif vr.isalpha() and vr.isupper():
                length = struct.unpack("<H", data[pos + 6:pos + 8])[0]
                hdr = 8
            else:  # implicit VR dataset
                vr = b"UN"
                length = struct.unpack("<I", data[pos + 4:pos + 8])[0]
                hdr = 8
        else:
            vr = b"UN"
            length = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            hdr = 8
        if length == 0xFFFFFFFF:
            raise ValueError("undefined-length (compressed/sequence) DICOM "
                             "elements are not supported by this reader")
        value = data[pos + hdr:pos + hdr + length]
        if tag == (0x0002, 0x0010):
            transfer_syntax = value.rstrip(b"\x00").decode("ascii")
            # 1.2.840.10008.1.2 = implicit VR LE; .1 = explicit VR LE
            if transfer_syntax == "1.2.840.10008.1.2":
                explicit = False
            elif transfer_syntax in ("1.2.840.10008.1.2.1",):
                explicit = True
            else:
                raise ValueError(
                    f"unsupported transfer syntax {transfer_syntax} "
                    "(only uncompressed little-endian)")
        out.elements[tag] = _parse_int_like(vr, value) if tag in (
            TAG_ROWS, TAG_COLS, TAG_BITS_ALLOC, TAG_PIXEL_REP) else value
        pos += hdr + length
    return out


def write_dicom(path: str, volume: np.ndarray, manufacturer: str = "Heidelberg",
                model: str = "Spectralis", implicit: bool = False) -> None:
    """Write a minimal little-endian multiframe DICOM (for tests/demos).

    implicit=True writes implicit-VR-LE (1.2.840.10008.1.2, the DICOM
    default syntax) dataset elements; the file-meta group is always
    explicit per the standard."""
    volume = np.asarray(volume)
    if volume.ndim == 2:
        volume = volume[None]
    frames, rows, cols = volume.shape
    assert volume.dtype in (np.uint8, np.uint16)
    bits = 8 if volume.dtype == np.uint8 else 16

    def element(group, elem, vr, value: bytes, implicit_el: bool = False):
        if len(value) % 2:
            value += b"\x00" if vr in (b"UI", b"OB", b"OW") else b" "
        if implicit_el:
            return struct.pack("<HHI", group, elem, len(value)) + value
        if vr in _EXPLICIT_LONG_VRS:
            return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
        return struct.pack("<HH2sH", group, elem, vr, len(value)) + value

    ts = b"1.2.840.10008.1.2" if implicit else b"1.2.840.10008.1.2.1"
    meta = element(0x0002, 0x0010, b"UI", ts)
    body = b"".join([
        element(0x0008, 0x0070, b"LO", manufacturer.encode(), implicit),
        element(0x0008, 0x1090, b"LO", model.encode(), implicit),
        element(0x0028, 0x0008, b"IS", str(frames).encode(), implicit),
        element(0x0028, 0x0010, b"US", struct.pack("<H", rows), implicit),
        element(0x0028, 0x0011, b"US", struct.pack("<H", cols), implicit),
        element(0x0028, 0x0100, b"US", struct.pack("<H", bits), implicit),
        element(0x7FE0, 0x0010, b"OW", volume.tobytes(), implicit),
    ])
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)
