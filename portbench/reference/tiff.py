"""A plain writer and reader of the one TIFF layout the TIFF recording
deployment uses, importing nothing of the port: an uncompressed little-endian
BigTIFF, one IFD and one strip a page, a page a (t, z, c) plane of a (T, Z, Y,
X, C) integer recording in the order T, then Z, then C (C fastest), and an
ImageJ hyperstack description on the first page
(``images=T*Z*C channels=C slices=Z frames=T hyperstack=true``), the layout of
upstream flowreg3D's ``util/io/tiff_3d.py`` writer.

``Writer`` streams a recording volume by volume: the pixel data first, the
IFDs when it is closed. ``Reader`` takes a file apart, checks that it is this
layout (else ``ValueError``) and decodes a volume at a time; its ``shape``
comes from the ImageJ description.
"""

import struct

import numpy as np

_BIGTIFF = b"II" + struct.pack("<HHHQ", 43, 8, 0, 0)
_FORMATS = {"u": 1, "i": 2}             # TIFF SampleFormat of an integer dtype
# the TIFF field types a page's IFD uses, and the struct formats of the numeric
_SHORT, _ASCII, _LONG, _LONG8 = 3, 2, 4, 16
_TYPE_FMT = {_SHORT: "H", _LONG: "I", _LONG8: "Q"}


def imagej_description(frames, slices, channels):
    return (f"ImageJ=1.54f\nimages={frames * slices * channels}\n"
            f"channels={channels}\nslices={slices}\nframes={frames}\n"
            "hyperstack=true\nmode=grayscale\nloop=false\n")


class Writer:
    """``write(volume)`` appends one (Z, Y, X, C) volume of ``dtype``;
    ``close()`` writes the IFDs and the header."""

    def __init__(self, path, volume_shape, dtype):
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in _FORMATS:
            raise ValueError(f"integer data only, not {self.dtype}")
        self.volume_shape = tuple(volume_shape)
        self.frames = 0
        self._fh = open(path, "wb")
        self._fh.write(b"\0" * len(_BIGTIFF))
        self._offsets = []

    def write(self, volume):
        vol = np.asarray(volume)
        if vol.shape != self.volume_shape or vol.dtype != self.dtype:
            raise ValueError(f"a volume is {self.volume_shape} "
                             f"{self.dtype}, not {vol.shape} {vol.dtype}")
        planes = np.ascontiguousarray(np.moveaxis(vol, -1, 1),
                                      self.dtype.newbyteorder("<"))
        start = self._fh.tell()
        self._fh.write(planes)                 # (Z, C, Y, X): z, then c
        page = planes[0, 0].nbytes
        self._offsets.extend(start + k * page
                             for k in range(planes.shape[0] * planes.shape[1]))
        self.frames += 1

    def _ifd(self, at, strip, description_at, description_len, last):
        """One page's IFD at file offset ``at``."""
        Z, Y, X, C = self.volume_shape
        tags = [(256, _LONG, 1, X), (257, _LONG, 1, Y),
                (258, _SHORT, 1, self.dtype.itemsize * 8),
                (259, _SHORT, 1, 1), (262, _SHORT, 1, 1)]
        if description_at is not None:
            tags.append((270, _ASCII, description_len, description_at))
        tags += [(273, _LONG8, 1, strip), (277, _SHORT, 1, 1),
                 (278, _LONG, 1, Y),
                 (279, _LONG8, 1, Y * X * self.dtype.itemsize),
                 (284, _SHORT, 1, 1),
                 (339, _SHORT, 1, _FORMATS[self.dtype.kind])]
        out = [struct.pack("<Q", len(tags))]
        for tag, typ, count, value in tags:
            fmt = "Q" if typ == _ASCII else _TYPE_FMT[typ]
            out.append(struct.pack("<HHQ", tag, typ, count)
                       + struct.pack("<" + fmt, value).ljust(8, b"\0"))
        body = b"".join(out)
        nxt = 0 if last else at + len(body) + 8
        return body + struct.pack("<Q", nxt)

    def close(self):
        if self._fh is None:
            return
        Z, Y, X, C = self.volume_shape
        desc = imagej_description(self.frames, Z, C).encode("ascii") + b"\0"
        at = self._fh.tell()
        desc_at = at
        self._fh.write(desc + b"\0" * (len(desc) % 2))
        at = self._fh.tell()
        first = at
        n = len(self._offsets)
        blobs = []
        for k, strip in enumerate(self._offsets):
            blob = self._ifd(at, strip, desc_at if k == 0 else None,
                             len(desc), k == n - 1)
            blobs.append(blob)
            at += len(blob)
        self._fh.write(b"".join(blobs))
        self._fh.seek(0)
        self._fh.write(_BIGTIFF[:8] + struct.pack("<Q", first if n else 0))
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Reader:
    """``shape`` (T, Z, Y, X, C) and ``dtype`` of a file of the layout;
    ``volume(t)`` decodes volume ``t`` as (Z, Y, X, C)."""

    def __init__(self, path):
        self._fh = open(path, "rb")
        try:
            self._parse()
        except (ValueError, struct.error):
            self.close()
            raise

    def _parse(self):
        head = self._fh.read(16)
        if head[:8] != _BIGTIFF[:8]:
            raise ValueError("not a little-endian BigTIFF")
        at = struct.unpack("<Q", head[8:16])[0]
        pages, description, seen = [], None, set()
        while at:
            if at in seen:
                raise ValueError("the IFDs form a loop")
            seen.add(at)
            self._fh.seek(at)
            n = struct.unpack("<Q", self._fh.read(8))[0]
            raw = self._fh.read(20 * n + 8)
            tags = {}
            for k in range(n):
                tag, typ, count = struct.unpack("<HHQ",
                                                raw[20 * k:20 * k + 12])
                value = raw[20 * k + 12:20 * k + 20]
                tags[tag] = (typ, count, value)
            at = struct.unpack("<Q", raw[20 * n:20 * n + 8])[0]
            if not pages and 270 in tags:
                typ, count, value = tags[270]
                if count > 8:
                    self._fh.seek(struct.unpack("<Q", value)[0])
                    value = self._fh.read(count)
                description = value[:count].rstrip(b"\0").decode("ascii")
            pages.append(self._page(tags))
        if not pages:
            raise ValueError("no pages")
        meta = dict(line.split("=", 1) for line in
                    (description or "").splitlines() if "=" in line)
        if "ImageJ" not in meta or meta.get("hyperstack") != "true":
            raise ValueError("no ImageJ hyperstack description")
        T, Z, C = (int(meta.get(k, 1)) for k in ("frames", "slices",
                                                 "channels"))
        width, length, bits, fmt, _ = pages[0]
        if any(p[:4] != pages[0][:4] for p in pages):
            raise ValueError("pages differ in size or sample type")
        if T * Z * C != len(pages) or int(meta.get("images", -1)) != len(pages):
            raise ValueError(f"{len(pages)} pages for T={T} Z={Z} C={C}")
        kind = {1: "u", 2: "i"}.get(fmt)
        if kind is None:
            raise ValueError(f"sample format {fmt}")
        self.dtype = np.dtype(f"<{kind}{bits // 8}")
        self.shape = (T, Z, length, width, C)
        self._strips = [p[4] for p in pages]

    @staticmethod
    def _page(tags):
        """(width, length, bits, sample format, strip offset) of one IFD;
        ``ValueError`` where the page is not one uncompressed strip of one
        sample."""
        def value(tag, default=None):
            if tag not in tags:
                if default is None:
                    raise ValueError(f"tag {tag} missing")
                return default
            typ, count, raw = tags[tag]
            if count != 1 or typ not in _TYPE_FMT:
                raise ValueError(f"tag {tag}: {count} values of type {typ}")
            fmt = _TYPE_FMT[typ]
            return struct.unpack("<" + fmt, raw[:struct.calcsize(fmt)])[0]

        width, length, bits = value(256), value(257), value(258)
        if (value(259, 1), value(277, 1), value(284, 1)) != (1, 1, 1):
            raise ValueError("compressed, multi-sample or planar pages")
        if (value(278, length) < length
                or value(279) != width * length * bits // 8):
            raise ValueError("a page is not one strip")
        return width, length, bits, value(339, 1), value(273)

    def volume(self, t):
        T, Z, Y, X, C = self.shape
        if not 0 <= t < T:
            raise IndexError(t)
        out = np.empty((Z, C, Y, X), self.dtype)
        for k in range(Z * C):
            self._fh.seek(self._strips[(t * Z * C) + k])
            out[k // C, k % C] = np.frombuffer(
                self._fh.read(Y * X * self.dtype.itemsize),
                self.dtype).reshape(Y, X)
        return np.ascontiguousarray(np.moveaxis(out, 1, -1),
                                    self.dtype.newbyteorder("="))

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
