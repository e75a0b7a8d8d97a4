"""ScanImage TIFF metadata parsing.

Parity target: reference util/io/_scanimage.py — extract channel/volume/
slice/frame-rate structure from ScanImage's key-value header
(``SI.<group>.<field> = <value>`` lines stored in the TIFF
ImageDescription/Software tags) and interpret it as volumetric dimensions.
"""

import ast
import re


def _parse_value(text):
    text = text.strip()
    if text in ("true", "false"):
        return text == "true"
    # MATLAB-style arrays: [1;2], [1 2 3]
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].replace(";", " ").replace(",", " ")
        parts = inner.split()
        try:
            return [_parse_value(p) for p in parts]
        except ValueError:
            return text
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_scanimage_header(text):
    """``SI.x.y = v`` lines -> nested dict under key path x.y."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"\s*(SI\.[\w.\[\]]+)\s*=\s*(.+)", line)
        if not m:
            continue
        out[m.group(1)] = _parse_value(m.group(2))
    return out


def parse_roi_groups(artist_text):
    """ScanImage ROI groups from the Artist-tag JSON.

    Parity: reference util/io/_scanimage.py roi_data — ScanImage stores
    mROI / scanfield geometry as JSON in TIFF tag 315 (Artist). Returns a
    dict with the raw group plus a flattened ``rois`` list of
    {name, enable, zs, scanfields: [{pixel_resolution (w,h), center_xy,
    size_xy}]}; None when absent/unparseable.
    """
    import json

    if not artist_text:
        return None
    try:
        data = json.loads(artist_text)
    except (ValueError, TypeError):
        return None
    groups = data.get("RoiGroups") or {}
    imaging = groups.get("imagingRoiGroup") or {}
    rois_in = imaging.get("rois")
    if rois_in is None:
        return None
    if isinstance(rois_in, dict):
        rois_in = [rois_in]
    rois = []
    for roi in rois_in:
        sfs = roi.get("scanfields") or []
        if isinstance(sfs, dict):
            sfs = [sfs]
        fields = []
        for sf in sfs:
            fields.append({
                "pixel_resolution": tuple(
                    sf.get("pixelResolutionXY") or (None, None)),
                "center_xy": tuple(sf.get("centerXY") or (None, None)),
                "size_xy": tuple(sf.get("sizeXY") or (None, None)),
            })
        zs = roi.get("zs", [])
        if not isinstance(zs, list):
            zs = [zs]
        rois.append({
            "name": roi.get("name"),
            "enable": bool(roi.get("enable", True)),
            "zs": zs,
            "scanfields": fields,
        })
    return {"rois": rois, "n_rois": len(rois), "raw": groups}


def extract_from_description(description):
    """Regex recovery of ScanImage fields from free-form description text.

    Parity: reference util/io/_scanimage.py:222-290
    (``_extract_from_description``) — older ScanImage builds store
    metadata as MATLAB-evaluable strings rather than the structured
    key-value header, and fields may be embedded mid-line (semicolon
    separated, wrapped in other text). Pattern-matches channels /
    slices / volumes / frames_per_slice / z_step / frame_rate and
    returns the recovered dict ({} when nothing matches).
    """
    patterns = {
        "channels": [
            (r"SI\.hChannels\.channelSave\s*=\s*\[([\d\s,;]+)\]", "list"),
            # reference parity (_scanimage.py:233-235,270): read as a count
            # in the description-only fallback — but NEVER override a
            # header-derived value with it (see parse_scanimage_metadata);
            # real ScanImage emits a channel id here for single channels
            (r"SI\.hChannels\.channelsActive\s*=\s*(\d+)", "int"),
        ],
        "slices_per_volume": [
            (r"SI\.hStackManager\.numSlices\s*=\s*(\d+)", "int"),
            (r"SI\.hFastZ\.numFramesPerVolume\s*=\s*(\d+)", "int"),
        ],
        "num_volumes": [
            (r"SI\.hFastZ\.numVolumes\s*=\s*(\d+)", "int"),
            (r"SI\.hStackManager\.numVolumes\s*=\s*(\d+)", "int"),
        ],
        "frames_per_slice": [
            (r"SI\.hStackManager\.framesPerSlice\s*=\s*(\d+)", "int"),
        ],
        "z_step": [
            # sign matters: descending stacks carry negative step sizes
            (r"SI\.hStackManager\.stackZStepSize\s*=\s*(-?[\d.]+)", "float"),
            (r"SI\.hFastZ\.positionAbsolute\s*=\s*\[([-\d.\s,;]+)\]",
             "zlist"),
        ],
        "frame_rate": [
            (r"SI\.hRoiManager\.scanFrameRate\s*=\s*([\d.]+)", "float"),
        ],
    }
    out = {}
    for key, pattern_list in patterns.items():
        for pattern, kind in pattern_list:
            m = re.search(pattern, description)
            if not m:
                continue
            text = m.group(1)
            if kind == "list":
                vals = text.replace(",", " ").replace(";", " ").split()
                out[key] = len(vals)
            elif kind == "zlist":
                zs = [float(x) for x in
                      text.replace(",", " ").replace(";", " ").split()]
                if len(zs) > 1:
                    out[key] = abs(zs[1] - zs[0])
            elif kind == "int":
                out[key] = int(text)
            else:
                out[key] = float(text)
            if key in out:
                break
    return out


def parse_scanimage_metadata(source):
    """Structured metadata from a TIFF path or raw header text.

    Returns None when no ScanImage header is present; else a dict with
    channels / slices_per_volume / frames_per_slice / num_volumes /
    frame_rate / z_step / roi_data / is_scanimage.
    """
    import os

    artist = None
    if isinstance(source, str) and "SI." not in source \
            and os.path.isfile(source):
        from flowreg3d_tpu_torch.io._tiff_format import TiffReader

        with TiffReader(source) as tr:
            text = tr.pages[0].description if tr.pages else ""
            artist = tr.pages[0].artist if tr.pages else None
            n_pages = tr.n_pages
    else:
        text = source
        n_pages = None

    fields = parse_scanimage_header(text or "")
    # description-embedded fallback/merge: older ScanImage builds bury the
    # fields mid-line — semicolon-separated, wrapped in other text — which
    # the line-oriented header parser misses or mangles (reference
    # _scanimage.py:222-290, _extract_from_description)
    rec = extract_from_description(text or "")
    if not fields and not rec:
        return None
    if not fields:
        return {
            "is_scanimage": True,
            "channels": int(rec.get("channels", 1) or 1),
            "slices_per_volume": int(rec.get("slices_per_volume", 1) or 1),
            "frames_per_slice": int(rec.get("frames_per_slice", 1) or 1),
            "num_volumes": (int(rec["num_volumes"])
                            if rec.get("num_volumes") else None),
            "z_step": rec.get("z_step"),
            "frame_rate": rec.get("frame_rate"),
            "volume_rate": None,
            "n_pages": n_pages,
            "roi_data": parse_roi_groups(artist),
            "raw_fields": rec,
        }

    def get(*names, default=None):
        for n in names:
            if n in fields:
                return fields[n]
        return default

    save = get("SI.hChannels.channelSave")
    if isinstance(save, (list, tuple)):
        channels = len(save)
    elif save is not None:
        channels = 1        # scalar channelSave = exactly one saved channel
    else:
        # no structured channel field at all: fall back to the description
        # extraction. The reference does the same (description extraction
        # only runs when the structured header is absent, _scanimage.py:
        # 155-168); a header-derived channels=1 must NOT be overridden by
        # channelsActive, which is a channel id for single-channel files.
        channels = int(rec.get("channels", 1) or 1)

    def _intlike(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    slices = get("SI.hStackManager.numSlices",
                 "SI.hStackManager.actualNumSlices", default=1)
    if not _intlike(slices):
        slices = rec.get("slices_per_volume", 1)
    frames_per_slice = get("SI.hStackManager.framesPerSlice", default=1)
    if not _intlike(frames_per_slice):
        frames_per_slice = rec.get("frames_per_slice", 1)
    num_volumes = get("SI.hStackManager.numVolumes",
                      "SI.hStackManager.actualNumVolumes", default=None)
    if num_volumes is not None and not _intlike(num_volumes):
        num_volumes = rec.get("num_volumes")
    z_step = get("SI.hStackManager.stackZStepSize",
                 default=rec.get("z_step"))
    frame_rate = get("SI.hRoiManager.scanFrameRate",
                     default=rec.get("frame_rate"))
    volume_rate = get("SI.hRoiManager.scanVolumeRate", default=None)

    # FastZ (piezo) volumetric mode overrides the stack manager counts
    # (reference _scanimage.py hFastZ handling)
    if get("SI.hFastZ.enable", default=False):
        fz_slices = get("SI.hFastZ.numFramesPerVolume", default=None)
        if fz_slices:
            slices = fz_slices
        fz_volumes = get("SI.hFastZ.numVolumes", default=None)
        if fz_volumes:
            num_volumes = fz_volumes

    meta = {
        "is_scanimage": True,
        "channels": int(channels),
        "slices_per_volume": int(slices) if slices else 1,
        "frames_per_slice": int(frames_per_slice) if frames_per_slice else 1,
        "num_volumes": int(num_volumes) if num_volumes else None,
        "z_step": z_step,
        "frame_rate": frame_rate,
        "volume_rate": volume_rate,
        "n_pages": n_pages,
        "roi_data": parse_roi_groups(artist),
        "raw_fields": fields,
    }
    return meta


def interpret_scanimage_dimensions(meta, n_pages=None):
    """(num_volumes, slices_per_volume, channels) from metadata + page count.

    When num_volumes is missing it is derived from the page count:
    pages = volumes * slices * frames_per_slice * channels.
    """
    slices = max(1, meta.get("slices_per_volume") or 1)
    channels = max(1, meta.get("channels") or 1)
    fps = max(1, meta.get("frames_per_slice") or 1)
    volumes = meta.get("num_volumes")
    # discrete-plane mROI acquisition: the per-ROI z list defines the
    # volumetric structure when the stack manager reports a flat stack
    roi = meta.get("roi_data")
    if slices == 1 and roi and roi.get("rois"):
        zs = sorted({z for r in roi["rois"] if r.get("enable", True)
                     for z in r.get("zs", [])})
        if len(zs) > 1:
            slices = len(zs)
    n_pages = n_pages if n_pages is not None else meta.get("n_pages")
    if volumes is None and n_pages:
        per_volume = slices * channels * fps
        volumes = max(1, n_pages // per_volume)
    return volumes or 1, slices, channels


def format_scanimage_report(meta):
    """Human-readable summary (parity: reference _scanimage.py report)."""
    if not meta:
        return "Not a ScanImage TIFF (no SI metadata found)."
    vol, sl, ch = interpret_scanimage_dimensions(meta)
    lines = [
        "ScanImage TIFF detected:",
        f"  channels:          {ch}",
        f"  slices/volume:     {sl}",
        f"  frames/slice:      {meta.get('frames_per_slice')}",
        f"  volumes:           {vol}",
    ]
    if meta.get("z_step") is not None:
        lines.append(f"  z step:            {meta['z_step']} um")
    if meta.get("frame_rate") is not None:
        lines.append(f"  frame rate:        {meta['frame_rate']} Hz")
    if meta.get("volume_rate") is not None:
        lines.append(f"  volume rate:       {meta['volume_rate']} Hz")
    roi = meta.get("roi_data")
    if roi and roi.get("rois"):
        lines.append(f"  ROIs:              {roi['n_rois']}")
        for r in roi["rois"]:
            res = [sf["pixel_resolution"] for sf in r["scanfields"]]
            lines.append(f"    - {r.get('name') or '(unnamed)'}: "
                         f"zs={r['zs']} px={res}")
    return "\n".join(lines)
