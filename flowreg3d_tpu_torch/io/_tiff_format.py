"""Minimal TIFF codec: classic + BigTIFF, uncompressed, ImageJ hyperstacks.

The environment carries no ``tifffile``, so this build ships its own codec.
Scope (sufficient for the framework's TIFF surface — reference
util/io/tiff_3d.py / tiff.py behaviors):

- **Read**: classic (II/MM) and BigTIFF; per-page IFDs; strips (and simple
  single-tile layouts); compression none/LZW/deflate(+zlib)/PackBits with
  horizontal-predictor support; sample formats uint/int/float at 8/16/32/64
  bits; PlanarConfig contig; multi-sample (RGB/multichannel) pages; ImageJ
  description metadata (images/channels/slices/frames/hyperstack) including
  ImageJ's "fake big TIFF" layout where only the first page has an IFD and
  remaining pages follow contiguously.
- **Write**: streaming page appends (pixel data written immediately, IFDs
  assembled at close), classic or BigTIFF, grayscale or multi-sample pages,
  ImageJ description on the first page for hyperstack round-trips. Writes
  are always uncompressed.

Not supported (raises): JPEG/other exotic compressions, planar=separate,
palettes, subifds. These are not produced by the reference pipeline.
"""

import io
import struct

import numpy as np

# TIFF tag ids
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_IMAGE_DESCRIPTION = 270
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_ARTIST = 315           # ScanImage stores ROI-group JSON here
TAG_PREDICTOR = 317
TAG_SAMPLE_FORMAT = 339
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325

# TIFF data types: id -> (struct fmt char, size)
_TYPES = {
    1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8),
}

_SAMPLE_FORMAT_UINT = 1
_SAMPLE_FORMAT_INT = 2
_SAMPLE_FORMAT_FLOAT = 3

_DTYPE_TO_FORMAT = {
    "u": _SAMPLE_FORMAT_UINT,
    "i": _SAMPLE_FORMAT_INT,
    "f": _SAMPLE_FORMAT_FLOAT,
}


def _np_dtype(sample_format, bits, byteorder):
    kind = {_SAMPLE_FORMAT_UINT: "u", _SAMPLE_FORMAT_INT: "i",
            _SAMPLE_FORMAT_FLOAT: "f"}.get(sample_format)
    if kind is None:
        raise ValueError(f"Unsupported TIFF sample format {sample_format}")
    return np.dtype(f"{byteorder}{kind}{bits // 8}")


def _lzw_decode(data):
    """TIFF-variant LZW (MSB-first bit packing, early code-width change).

    Clear=256, EOI=257; code width grows at table sizes 511/1023/2047
    (TIFF's off-by-one vs classic LZW). Reference behavior target:
    util/io/tiff.py via tifffile's imagecodecs."""
    out = bytearray()
    table = None
    prev = None
    width = 9
    buf = 0
    nbits = 0
    next_code = 258

    def reset():
        nonlocal table, width, next_code, prev
        table = {i: bytes((i,)) for i in range(256)}
        width = 9
        next_code = 258
        prev = None

    reset()
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= width:
            nbits -= width
            code = (buf >> nbits) & ((1 << width) - 1)
            if code == 256:
                reset()
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code in table:
                entry = table[code]
                table[next_code] = prev + entry[:1]
                next_code += 1
            else:
                entry = prev + prev[:1]
                table[next_code] = entry
                next_code += 1
            out += entry
            prev = entry
            if next_code in (511, 1023, 2047):
                width += 1
    return bytes(out)


def _packbits_decode(data):
    """PackBits RLE (compression 32773)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out)


def _undo_horizontal_predictor(raw, n_rows, width, samples, itemsize,
                               byteorder):
    """Predictor 2: cumulative sum along each row per sample channel."""
    dt = np.dtype(f"{byteorder}u{itemsize}" if itemsize > 1 else "u1")
    arr = np.frombuffer(raw, dt).reshape(n_rows, width, samples)
    # cumulative sum with wraparound == undoing the difference predictor
    arr = np.cumsum(arr, axis=1, dtype=np.uint64).astype(dt)
    return arr.tobytes()


class TiffPage:
    """Parsed IFD of one page."""

    __slots__ = ("width", "length", "bits", "samples", "compression",
                 "photometric", "sample_format", "rows_per_strip",
                 "strip_offsets", "strip_byte_counts", "description",
                 "planar_config", "offset", "artist", "predictor")

    def __init__(self):
        self.width = 0
        self.length = 0
        self.bits = 8
        self.samples = 1
        self.compression = 1
        self.photometric = 1
        self.sample_format = _SAMPLE_FORMAT_UINT
        self.rows_per_strip = 2 ** 32 - 1
        self.strip_offsets = []
        self.strip_byte_counts = []
        self.description = ""
        self.planar_config = 1
        self.offset = 0
        self.artist = ""
        self.predictor = 1

    @property
    def shape(self):
        return ((self.length, self.width) if self.samples == 1
                else (self.length, self.width, self.samples))

    def nbytes(self):
        return self.length * self.width * self.samples * (self.bits // 8)


class TiffReader:
    """Random-access page reader over a TIFF file."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        header = self._fh.read(8)
        if header[:2] == b"II":
            self.byteorder = "<"
        elif header[:2] == b"MM":
            self.byteorder = ">"
        else:
            raise ValueError(f"Not a TIFF file: {self.path}")
        magic = struct.unpack(self.byteorder + "H", header[2:4])[0]
        if magic == 42:
            self.big = False
            first_ifd = struct.unpack(self.byteorder + "I", header[4:8])[0]
        elif magic == 43:
            self.big = True
            rest = self._fh.read(8)
            offsize = struct.unpack(self.byteorder + "H", header[4:6])[0]
            if offsize != 8:
                raise ValueError("Invalid BigTIFF offset size")
            first_ifd = struct.unpack(self.byteorder + "Q", rest[:8])[0]
        else:
            raise ValueError(f"Invalid TIFF magic {magic}")
        self.pages = []
        self._parse_ifds(first_ifd)
        self._imagej = parse_imagej_description(
            self.pages[0].description if self.pages else "")
        self._virtual_pages = None
        if self._imagej:
            n = self._imagej.get("images", 0)
            if n > len(self.pages) and len(self.pages) >= 1:
                # ImageJ contiguous layout: pages follow the first one back
                # to back without IFDs
                self._virtual_pages = n

    # -- IFD parsing --------------------------------------------------------

    def _read(self, off, size):
        self._fh.seek(off)
        return self._fh.read(size)

    def _parse_ifds(self, offset, max_pages=10 ** 7):
        bo = self.byteorder
        count_fmt = "Q" if self.big else "H"
        count_size = 8 if self.big else 2
        entry_size = 20 if self.big else 12
        next_size = 8 if self.big else 4
        seen = set()
        while offset and offset not in seen and len(self.pages) < max_pages:
            seen.add(offset)
            n = struct.unpack(bo + count_fmt, self._read(offset, count_size))[0]
            data = self._read(offset + count_size, n * entry_size + next_size)
            page = TiffPage()
            page.offset = offset
            for i in range(n):
                e = data[i * entry_size:(i + 1) * entry_size]
                self._apply_entry(page, e)
            self.pages.append(page)
            offset = struct.unpack(
                bo + ("Q" if self.big else "I"),
                data[n * entry_size: n * entry_size + next_size])[0]

    def _entry_values(self, entry):
        bo = self.byteorder
        if self.big:
            tag, typ = struct.unpack(bo + "HH", entry[:4])
            cnt = struct.unpack(bo + "Q", entry[4:12])[0]
            payload = entry[12:20]
            inline = 8
        else:
            tag, typ = struct.unpack(bo + "HH", entry[:4])
            cnt = struct.unpack(bo + "I", entry[4:8])[0]
            payload = entry[8:12]
            inline = 4
        if typ not in _TYPES:
            return tag, None
        fmt, size = _TYPES[typ]
        total = size * cnt
        if total > inline:
            off = struct.unpack(bo + ("Q" if self.big else "I"), payload)[0]
            raw = self._read(off, total)
        else:
            raw = payload[:total]
        if typ == 2:  # ASCII
            return tag, raw.rstrip(b"\x00").decode("ascii", "replace")
        if typ in (5, 10):  # rationals -> floats
            ints = struct.unpack(bo + ("I" if typ == 5 else "i") * (2 * cnt), raw)
            return tag, [ints[2 * i] / (ints[2 * i + 1] or 1) for i in range(cnt)]
        vals = struct.unpack(bo + fmt * cnt, raw)
        return tag, list(vals)

    def _apply_entry(self, page, entry):
        tag, vals = self._entry_values(entry)
        if vals is None:
            return
        if tag == TAG_IMAGE_WIDTH:
            page.width = int(vals[0])
        elif tag == TAG_IMAGE_LENGTH:
            page.length = int(vals[0])
        elif tag == TAG_BITS_PER_SAMPLE:
            page.bits = int(vals[0])
        elif tag == TAG_COMPRESSION:
            page.compression = int(vals[0])
        elif tag == TAG_PHOTOMETRIC:
            page.photometric = int(vals[0])
        elif tag == TAG_IMAGE_DESCRIPTION:
            page.description = vals
        elif tag == TAG_ARTIST:
            page.artist = vals
        elif tag in (TAG_STRIP_OFFSETS, TAG_TILE_OFFSETS):
            page.strip_offsets = [int(v) for v in vals]
        elif tag == TAG_SAMPLES_PER_PIXEL:
            page.samples = int(vals[0])
        elif tag == TAG_ROWS_PER_STRIP:
            page.rows_per_strip = int(vals[0])
        elif tag in (TAG_STRIP_BYTE_COUNTS, TAG_TILE_BYTE_COUNTS):
            page.strip_byte_counts = [int(v) for v in vals]
        elif tag == TAG_PLANAR_CONFIG:
            page.planar_config = int(vals[0])
        elif tag == TAG_SAMPLE_FORMAT:
            page.sample_format = int(vals[0])
        elif tag == TAG_PREDICTOR:
            page.predictor = int(vals[0])

    # -- data access --------------------------------------------------------

    @property
    def n_pages(self):
        return self._virtual_pages or len(self.pages)

    @property
    def imagej_metadata(self):
        return self._imagej

    def page_array(self, index):
        """Decode page ``index`` to a numpy array (H, W[, S])."""
        if self._virtual_pages and index > 0:
            page = self.pages[0]
            if index >= self._virtual_pages:
                raise IndexError(index)
            base = page.strip_offsets[0]
            data = self._read(base + index * page.nbytes(), page.nbytes())
        else:
            page = self.pages[index]
            if page.compression not in (1, 5, 8, 32773, 32946):
                raise NotImplementedError(
                    f"TIFF compression {page.compression} not supported "
                    "(supported: none, LZW, deflate, PackBits)")
            if page.planar_config != 1:
                raise NotImplementedError("planar TIFF not supported")
            rows_per_strip = min(page.rows_per_strip, page.length)
            row_bytes = page.width * page.samples * (page.bits // 8)
            chunks = []
            for k, (off, cnt) in enumerate(
                    zip(page.strip_offsets, page.strip_byte_counts)):
                raw = self._read(off, cnt)
                if page.compression == 1:
                    chunks.append(raw)
                    continue
                n_rows = min(rows_per_strip,
                             page.length - k * rows_per_strip)
                if page.compression == 5:
                    raw = _lzw_decode(raw)
                elif page.compression in (8, 32946):
                    import zlib

                    raw = zlib.decompress(raw)
                elif page.compression == 32773:
                    raw = _packbits_decode(raw)
                raw = raw[:n_rows * row_bytes]
                if page.predictor == 2:
                    raw = _undo_horizontal_predictor(
                        raw, n_rows, page.width, page.samples,
                        page.bits // 8, self.byteorder)
                chunks.append(raw)
            data = b"".join(chunks)
        dt = _np_dtype(page.sample_format, page.bits, self.byteorder)
        arr = np.frombuffer(data, dtype=dt, count=page.nbytes() // dt.itemsize)
        return arr.reshape(page.shape).astype(dt.newbyteorder("=")) \
            if self.byteorder != "=" else arr.reshape(page.shape)

    def asarray(self):
        """All pages stacked: (N, H, W[, S])."""
        return np.stack([self.page_array(i) for i in range(self.n_pages)])

    def memmap_pages(self):
        """Zero-copy (N, H, W[, S]) view over the file, or None.

        The layout analogue of the reference's ``asarray(out="memmap")``
        (reference util/io/tiff.py:41-55, :444-445): eligible when every
        page is uncompressed with contiguous strip runs, pages share
        shape/dtype, and consecutive pages sit at a constant byte stride
        (which covers back-to-back writers and ImageJ's contiguous
        "fake big TIFF" layout). RSS stays bounded: the OS pages data in
        per access instead of the whole file materializing.
        """
        if not self.pages:
            return None
        p0 = self.pages[0]
        dt = _np_dtype(p0.sample_format, p0.bits, self.byteorder)
        page_bytes = p0.nbytes()

        if self._virtual_pages:
            n = self._virtual_pages
            base = p0.strip_offsets[0]
            stride = page_bytes
        else:
            offs = []
            for p in self.pages:
                if (p.compression != 1 or p.planar_config != 1
                        or p.shape != p0.shape or p.bits != p0.bits
                        or p.sample_format != p0.sample_format
                        or not p.strip_offsets):
                    return None
                run = p.strip_offsets[0]
                for o, c in zip(p.strip_offsets, p.strip_byte_counts):
                    if o != run:
                        return None
                    run = o + c
                if run - p.strip_offsets[0] != page_bytes:
                    return None
                offs.append(p.strip_offsets[0])
            n = len(offs)
            base = offs[0]
            stride = page_bytes if n == 1 else offs[1] - offs[0]
            if stride < page_bytes or stride % dt.itemsize:
                return None
            if any(offs[i + 1] - offs[i] != stride for i in range(n - 1)):
                return None
        if base % dt.itemsize:
            return None

        mm = np.memmap(self.path, dtype=dt, mode="r",
                       offset=base, shape=(stride // dt.itemsize * (n - 1)
                                           + page_bytes // dt.itemsize,))
        from numpy.lib.stride_tricks import as_strided

        page_strides = []
        acc = dt.itemsize
        for dim in reversed(p0.shape):
            page_strides.append(acc)
            acc *= dim
        page_strides = tuple(reversed(page_strides))
        return as_strided(mm, shape=(n,) + p0.shape,
                          strides=(stride,) + page_strides, writeable=False)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_imagej_description(desc):
    """Parse ImageJ=... key=value description into a dict (or None)."""
    if not desc or not desc.startswith("ImageJ"):
        return None
    meta = {}
    for line in desc.splitlines():
        if "=" not in line:
            continue
        key, val = line.split("=", 1)
        key = key.strip()
        val = val.strip()
        if key == "ImageJ":
            meta["version"] = val
            continue
        if val.lower() in ("true", "false"):
            meta[key] = val.lower() == "true"
            continue
        try:
            meta[key] = int(val)
        except ValueError:
            try:
                meta[key] = float(val)
            except ValueError:
                meta[key] = val
    return meta


def build_imagej_description(n_images, channels=1, slices=1, frames=1,
                             version="1.54f"):
    lines = [f"ImageJ={version}", f"images={n_images}"]
    if channels > 1:
        lines.append(f"channels={channels}")
    if slices > 1:
        lines.append(f"slices={slices}")
    if frames > 1:
        lines.append(f"frames={frames}")
    if channels > 1 or slices > 1 or frames > 1:
        lines.append("hyperstack=true")
    lines.append("mode=grayscale")
    lines.append("loop=false")
    return "\n".join(lines) + "\n"


class TiffWriter:
    """Streaming TIFF writer: append pages, IFDs written at close.

    ``bigtiff=None`` auto-upgrades: the format is chosen at close time based
    on total size (data is written format-agnostically first).
    """

    def __init__(self, path, bigtiff=None):
        self.path = str(path)
        self._fh = open(self.path, "wb")
        self._bigtiff = bigtiff
        self._pages = []  # (offset, nbytes, shape, dtype)
        self._description_first = None
        self._artist_first = None
        # reserve the maximal (BigTIFF) header; classic header fits inside
        self._fh.write(b"\x00" * 16)
        self._pos = 16

    def write_page(self, arr, description=None):
        arr = np.ascontiguousarray(arr)
        if arr.ndim not in (2, 3):
            raise ValueError("page must be (H,W) or (H,W,S)")
        if arr.dtype.kind not in _DTYPE_TO_FORMAT:
            raise ValueError(f"Unsupported dtype {arr.dtype}")
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        off = self._pos
        self._fh.write(data)
        self._pos += len(data)
        if description is not None and self._description_first is None:
            self._description_first = description
        self._pages.append((off, len(data), arr.shape, arr.dtype))

    def set_description(self, description):
        self._description_first = description

    def set_artist(self, artist):
        """Artist tag on the first page (ScanImage ROI-group JSON)."""
        self._artist_first = artist

    # -- IFD assembly -------------------------------------------------------

    def _pack_entry(self, out, tag, typ, values, big, extra_chunks):
        fmt, size = _TYPES[typ]
        cnt = len(values) if isinstance(values, (list, tuple, bytes)) else 1
        if isinstance(values, bytes):
            raw = values
        else:
            vals = values if isinstance(values, (list, tuple)) else [values]
            raw = struct.pack("<" + fmt * len(vals), *vals)
        inline = 8 if big else 4
        head = struct.pack("<HH", tag, typ)
        cnt_fmt = "<Q" if big else "<I"
        if len(raw) <= inline:
            out.append(head + struct.pack(cnt_fmt, cnt)
                       + raw.ljust(inline, b"\x00"))
        else:
            # record a placeholder; chunk offsets resolved by caller
            out.append([head + struct.pack(cnt_fmt, cnt), raw])
            extra_chunks.append(out[-1])

    def close(self):
        if self._fh is None:
            return
        big = self._bigtiff
        if big is None:
            big = self._pos + 1024 * len(self._pages) > 2 ** 31 - 2 ** 16
        entry_size = 20 if big else 12
        count_size = 8 if big else 2
        next_size = 8 if big else 4
        off_typ = 16 if big else 4  # LONG8 vs LONG

        ifd_offsets = []
        ifd_blobs = []
        pos = self._pos
        # first pass: build IFD blobs with out-of-line chunks appended after
        for idx, (off, nbytes, shape, dtype) in enumerate(self._pages):
            h, w = shape[:2]
            samples = shape[2] if len(shape) == 3 else 1
            entries = []
            chunks = []
            desc = self._description_first if idx == 0 else None
            self._pack_entry(entries, TAG_IMAGE_WIDTH, 4, w, big, chunks)
            self._pack_entry(entries, TAG_IMAGE_LENGTH, 4, h, big, chunks)
            if samples > 1:
                self._pack_entry(entries, TAG_BITS_PER_SAMPLE, 3,
                                 [dtype.itemsize * 8] * samples, big, chunks)
            else:
                self._pack_entry(entries, TAG_BITS_PER_SAMPLE, 3,
                                 dtype.itemsize * 8, big, chunks)
            self._pack_entry(entries, TAG_COMPRESSION, 3, 1, big, chunks)
            self._pack_entry(entries, TAG_PHOTOMETRIC, 3, 1, big, chunks)
            if desc:
                self._pack_entry(entries, TAG_IMAGE_DESCRIPTION, 2,
                                 desc.encode("ascii") + b"\x00", big, chunks)
            self._pack_entry(entries, TAG_STRIP_OFFSETS, off_typ, off, big,
                             chunks)
            self._pack_entry(entries, TAG_SAMPLES_PER_PIXEL, 3, samples, big,
                             chunks)
            self._pack_entry(entries, TAG_ROWS_PER_STRIP, 4, h, big, chunks)
            self._pack_entry(entries, TAG_STRIP_BYTE_COUNTS, off_typ, nbytes,
                             big, chunks)
            self._pack_entry(entries, TAG_PLANAR_CONFIG, 3, 1, big, chunks)
            if idx == 0 and self._artist_first:
                self._pack_entry(entries, TAG_ARTIST, 2,
                                 self._artist_first.encode("ascii")
                                 + b"\x00", big, chunks)
            self._pack_entry(entries, TAG_SAMPLE_FORMAT, 3,
                             _DTYPE_TO_FORMAT[dtype.kind], big, chunks)

            ifd_size = count_size + len(entries) * entry_size + next_size
            chunk_pos = pos + ifd_size
            blob = io.BytesIO()
            blob.write(struct.pack("<Q" if big else "<H", len(entries)))
            chunk_data = b""
            for e in entries:
                if isinstance(e, list):
                    head, raw = e
                    blob.write(head + struct.pack("<Q" if big else "<I",
                                                  chunk_pos + len(chunk_data)))
                    pad = (-len(raw)) % 2
                    chunk_data += raw + b"\x00" * pad
                else:
                    blob.write(e)
            ifd_offsets.append(pos)
            ifd_blobs.append((blob, chunk_data))
            pos += ifd_size + len(chunk_data)

        # second pass: fill next-IFD pointers and write
        self._fh.seek(self._pos)
        for i, (blob, chunk_data) in enumerate(ifd_blobs):
            nxt = ifd_offsets[i + 1] if i + 1 < len(ifd_offsets) else 0
            blob.write(struct.pack("<Q" if big else "<I", nxt))
            self._fh.write(blob.getvalue())
            self._fh.write(chunk_data)

        # header
        self._fh.seek(0)
        first = ifd_offsets[0] if ifd_offsets else 0
        if big:
            self._fh.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, first))
        else:
            self._fh.write(b"II" + struct.pack("<HI", 42, first))
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
