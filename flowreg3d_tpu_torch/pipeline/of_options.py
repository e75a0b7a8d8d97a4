"""OFOptions: the pipeline's user-facing configuration, without pydantic.

Counterpart of ``flowreg3d_tpu/pipeline/of_options.py``: the same fields,
defaults and enums, the same normalisation of alpha (-> 3-tuple), weight
(-> sum 1) and sigma (-> (C, 4)), the same range checks and quality logic
(``min_level >= 0`` makes the preset CUSTOM; ``effective_min_level`` maps
the presets to 0/4/6), ``get_sigma_at``, ``get_weight_at``, ``copy``,
``to_dict``, the reader and writer (the output file named by the naming
convention, the CaImAn/Begonia/Suite2p formats on their backends) and
``get_reference_frame`` for an ndarray, a TIFF file or an index list
(optionally pre-registered with alpha + 2). A dataclass validated once, at
construction, as the pydantic model is. ``save_options`` / ``load_options``
keep the JAX package's file layout (a dated header line, then the JSON,
enums as values, an ndarray reference in ``reference_frames.tif`` beside
it), so a file either package saves loads in the other.
``get_mcp_schema`` builds the model's JSON schema (pydantic's,
serialization mode) from the dataclass fields; ``compensate_inplace`` is the
in-memory entry point.
"""

import copy
import dataclasses
import json
import typing
import warnings
from dataclasses import dataclass, field
from datetime import date
from enum import Enum
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np

from flowreg3d_tpu_torch.io.base import VideoReader3D, VideoWriter3D


class OutputFormat(str, Enum):
    TIFF = "TIFF"
    HDF5 = "HDF5"
    MAT = "MAT"
    MULTIFILE_TIFF = "MULTIFILE_TIFF"
    MULTIFILE_MAT = "MULTIFILE_MAT"
    MULTIFILE_HDF5 = "MULTIFILE_HDF5"
    CAIMAN_HDF5 = "CAIMAN_HDF5"
    BEGONIA = "BEGONIA"
    SUITE2P_TIFF = "SUITE2P_TIFF"
    ARRAY = "ARRAY"


class QualitySetting(str, Enum):
    QUALITY = "quality"
    BALANCED = "balanced"
    FAST = "fast"
    CUSTOM = "custom"


class ChannelNormalization(str, Enum):
    JOINT = "joint"
    SEPARATE = "separate"


class InterpolationMethod(str, Enum):
    NEAREST = "nearest"
    LINEAR = "linear"
    CUBIC = "cubic"


class ConstancyAssumption(str, Enum):
    GRAY = "gray"
    GRADIENT = "gc"


class NamingConvention(str, Enum):
    DEFAULT = "default"
    BATCH = "batch"


_QUALITY_MIN_LEVEL = {
    QualitySetting.QUALITY: 0,
    QualitySetting.BALANCED: 4,
    QualitySetting.FAST: 6,
}

# formats written by another format's writer
_FORMAT_BACKEND = {
    OutputFormat.CAIMAN_HDF5: "HDF5",
    OutputFormat.BEGONIA: "MAT",
    OutputFormat.SUITE2P_TIFF: "TIFF",
}

_ENUMS = {
    "output_format": OutputFormat,
    "quality_setting": QualitySetting,
    "channel_normalization": ChannelNormalization,
    "interpolation_method": InterpolationMethod,
    "naming_convention": NamingConvention,
    "constancy_assumption": ConstancyAssumption,
}

# integer field -> its least value
_INT_RANGES = {"levels": 1, "min_level": -1, "update_lag": 1,
               "iterations": 1, "bin_size": 1, "buffer_size": 1,
               "n_references": 1, "min_frames_per_reference": 1, "cc_up": 1}
# float field -> (lower bound, lower bound exclusive, upper bound)
_FLOAT_RANGES = {"eta": (0.0, True, 1.0), "a_smooth": (0.0, False, None),
                 "a_data": (0.0, True, 1.0)}


def _normalize_alpha(v):
    vals = [v] if isinstance(v, (int, float)) else list(v)
    if len(vals) == 1:
        vals = vals * 3
    elif len(vals) == 2:
        # legacy 2D (ax, ay): duplicate the first value for z
        vals = [vals[0], vals[0], vals[1]]
    elif len(vals) != 3:
        raise ValueError("Alpha must be scalar, 2-element, or 3-element")
    vals = [float(a) for a in vals]
    if any(a <= 0 for a in vals):
        raise ValueError("All alpha values must be positive")
    return tuple(vals)


def _normalize_weight(v):
    arr = np.asarray(v, dtype=float)
    if arr.ndim == 1:
        if arr.sum() > 0:
            arr = arr / arr.sum()
        return arr.tolist()
    # spatial weight maps ((C,Z,Y,X) or (Z,Y,X)) stay as ndarrays
    return arr


def _normalize_sigma(v):
    sig = np.asarray(v, dtype=float)
    if sig.ndim == 1:
        if sig.size == 3:  # 2D [sx,sy,st] -> insert sz=1
            sig = np.insert(sig, 2, 1.0)
        elif sig.size != 4:
            raise ValueError("1D sigma must be [sx,sy,sz,st] or [sx,sy,st]")
        return sig.reshape(1, 4).tolist()
    if sig.ndim == 2:
        if sig.shape[1] == 3:
            sig = np.insert(sig, 2, 1.0, axis=1)
        elif sig.shape[1] != 4:
            raise ValueError("2D sigma must be (n_channels, 4)")
        return sig.tolist()
    raise ValueError("Sigma must be [sx,sy,sz,st] or (n_channels, 4)")


def _read_tiff_pages(path):
    """All pages of a TIFF file, (N, H, W[, S])."""
    from flowreg3d_tpu_torch.io._tiff_format import TiffReader

    with TiffReader(str(path)) as tr:
        return tr.asarray()


@dataclass(repr=False)
class OFOptions:
    """Motion-correction options; the public API contract of the pipeline."""

    # I/O
    input_file: Optional[Union[str, Path, np.ndarray, VideoReader3D,
                               List[str]]] = None
    input_dim_order: str = "TZYX"
    output_path: Path = Path("results")
    output_format: OutputFormat = OutputFormat.MAT
    output_file_name: Optional[str] = None
    channel_idx: Optional[List[int]] = None

    # Flow parameters
    alpha: Union[float, Tuple[float, float],
                 Tuple[float, float, float]] = (0.25, 0.25, 0.25)
    weight: Union[List[float], np.ndarray] = field(
        default_factory=lambda: [0.5, 0.5])
    levels: int = 100
    min_level: int = 5
    quality_setting: QualitySetting = QualitySetting.QUALITY
    eta: float = 0.8
    update_lag: int = 5
    iterations: int = 100
    a_smooth: float = 1.0
    a_data: float = 0.45

    # Preprocessing
    sigma: Any = field(default_factory=lambda: [[1.0, 1.0, 1.0, 0.1],
                                                [1.0, 1.0, 1.0, 0.1]])
    bin_size: int = 1
    buffer_size: int = 10

    # Reference
    reference_frames: Union[List[int], str, Path, np.ndarray] = field(
        default_factory=lambda: list(range(50, 500)))
    update_reference: bool = False
    n_references: int = 1
    min_frames_per_reference: int = 20
    preregister_reference: bool = field(default=False, metadata={
        "description": "Pre-register index-list references with alpha+2 "
                       "before averaging (3D extension of the reference's "
                       "2D prereg path)"})

    # Processing options
    verbose: bool = False
    save_meta_info: bool = True
    save_w: bool = False
    save_valid_mask: bool = False
    save_valid_idx: bool = False
    output_typename: Optional[str] = "double"
    channel_normalization: ChannelNormalization = ChannelNormalization.JOINT
    interpolation_method: InterpolationMethod = InterpolationMethod.CUBIC
    cc_initialization: bool = False
    cc_hw: Union[int, Tuple[int, int]] = 256
    cc_up: int = 10
    update_initialization_w: bool = True
    naming_convention: NamingConvention = NamingConvention.DEFAULT
    constancy_assumption: ConstancyAssumption = ConstancyAssumption.GRADIENT

    preproc_funct: Optional[Callable] = None

    _video_reader: Optional[VideoReader3D] = field(default=None, init=False)
    _video_writer: Optional[VideoWriter3D] = field(default=None, init=False)
    _quality_setting_old: QualitySetting = field(
        default=QualitySetting.QUALITY, init=False)

    # -- validation ---------------------------------------------------------

    def __post_init__(self):
        for name, enum in _ENUMS.items():
            setattr(self, name, enum(getattr(self, name)))
        for name, lo in _INT_RANGES.items():
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
                raise ValueError(f"{name} must be an int, got {v!r}")
            if v < lo:
                raise ValueError(f"{name} must be >= {lo}, got {v}")
            setattr(self, name, int(v))
        for name, (lo, lo_open, hi) in _FLOAT_RANGES.items():
            v = float(getattr(self, name))
            if v < lo or (lo_open and v == lo) or (hi is not None and v > hi):
                raise ValueError(f"{name} out of range: {v}")
            setattr(self, name, v)
        self.alpha = _normalize_alpha(self.alpha)
        self.weight = _normalize_weight(self.weight)
        self.sigma = _normalize_sigma(self.sigma)
        self.output_path = Path(self.output_path)
        if isinstance(self.cc_hw, list):    # as pydantic reads a JSON pair
            self.cc_hw = tuple(self.cc_hw)
        # quality logic: an explicit min_level makes the preset CUSTOM
        if self.quality_setting != QualitySetting.CUSTOM:
            self._quality_setting_old = self.quality_setting
        if self.min_level >= 0:
            self.quality_setting = QualitySetting.CUSTOM
        elif self.quality_setting == QualitySetting.CUSTOM:
            self.quality_setting = self._quality_setting_old

    # -- derived ------------------------------------------------------------

    @property
    def effective_min_level(self) -> int:
        if self.min_level >= 0:
            return self.min_level
        return _QUALITY_MIN_LEVEL.get(self.quality_setting,
                                      max(self.min_level, 0))

    @property
    def constancy(self) -> str:
        return self.constancy_assumption.value

    @constancy.setter
    def constancy(self, value):
        self.constancy_assumption = ConstancyAssumption(value)

    def get_sigma_at(self, i: int) -> np.ndarray:
        sig = np.asarray(self.sigma, dtype=float)
        if sig.ndim == 1:
            return sig
        return sig[i] if i < sig.shape[0] else sig[0]

    def get_weight_at(self, i: int, n_channels: int):
        w = np.asarray(self.weight, dtype=float)
        if w.ndim <= 1:
            if w.size == 1:
                return float(w.reshape(-1)[0])
            if w.size > n_channels:
                w = w[:n_channels]
                w = w / w.sum()
                self.weight = w.tolist()
            if i >= w.size:
                return 1.0 / n_channels
            return float(w[i])
        if i >= w.shape[0]:
            return np.ones(w.shape[1:]) / n_channels
        return w[i]

    def copy(self) -> "OFOptions":
        return copy.deepcopy(self)

    def replace(self, **changes) -> "OFOptions":
        """A deep copy with ``changes`` set, not re-validated (pydantic's
        ``model_copy(update=...)``)."""
        out = self.copy()
        for name, value in changes.items():
            if name not in {f.name for f in dataclasses.fields(self)}:
                raise TypeError(f"OFOptions has no field {name!r}")
            setattr(out, name, value)
        return out

    # -- reader / writer ----------------------------------------------------

    def get_video_reader(self) -> VideoReader3D:
        if self._video_reader is not None:
            return self._video_reader
        from flowreg3d_tpu_torch.io.factory import get_video_file_reader

        self._video_reader = get_video_file_reader(
            self.input_file, buffer_size=self.buffer_size,
            bin_size=self.bin_size, dim_order=self.input_dim_order)
        self.input_file = self._video_reader
        return self._video_reader

    def get_video_writer(self) -> VideoWriter3D:
        if self._video_writer is not None:
            return self._video_writer
        from flowreg3d_tpu_torch.io.factory import get_video_file_writer

        fmt = self.output_format
        backend = _FORMAT_BACKEND.get(fmt, fmt.value)
        writer_kwargs = {}
        if fmt == OutputFormat.CAIMAN_HDF5:
            # CaImAn convention: a single dataset named 'mov', time-major
            writer_kwargs = {"dataset_names": "mov",
                             "dimension_ordering": (1, 2, 3, 0)}
        if self.output_file_name:
            filename = self.output_file_name
        elif fmt == OutputFormat.ARRAY:
            filename = None
        else:
            # MULTIFILE_<FMT> writers split per channel; name by base format
            ext = backend.split("_")[-1] if backend.startswith("MULTIFILE") \
                else backend
            if self.naming_convention == NamingConvention.DEFAULT:
                filename = str(self.output_path / f"compensated.{ext}")
            else:
                reader = self.get_video_reader()
                stem = Path(getattr(reader, "file_path", "output")).stem
                filename = str(self.output_path / f"{stem}_compensated.{ext}")
        self._video_writer = get_video_file_writer(filename, backend,
                                                   **writer_kwargs)
        return self._video_writer

    # -- reference ----------------------------------------------------------

    def get_reference_frame(self, video_reader=None, **compensate_kwargs):
        """Reference volume (Z,Y,X,C): ndarray passthrough, a TIFF file, or
        the mean over an index list (optionally pre-registered with alpha + 2;
        ``compensate_kwargs``, e.g. ``device``, go to ``compensate_arr``)."""
        if self.n_references > 1:
            warnings.warn("Multi-reference mode repeats a single reference")
            single = self.replace(n_references=1)
            ref = single.get_reference_frame(video_reader,
                                             **compensate_kwargs)
            return [ref] * self.n_references

        if isinstance(self.reference_frames, np.ndarray):
            return self.reference_frames

        if isinstance(self.reference_frames, (str, Path)):
            p = Path(self.reference_frames)
            if p.suffix.lower() in (".tif", ".tiff"):
                arr = _read_tiff_pages(p)
                return arr[0] if arr.shape[0] == 1 else arr
            raise ValueError(f"Unsupported reference image format: {p.suffix}")

        if isinstance(self.reference_frames, list) and video_reader is not None:
            idx = [i for i in self.reference_frames
                   if i < video_reader.binned_count]
            if not idx:
                idx = [0]
            frames = video_reader[idx]  # (T,Z,Y,X,C)
            if frames.ndim == 4:
                return frames
            if frames.shape[0] == 1 or not self.preregister_reference:
                return frames.mean(axis=0)
            return self._preregister_reference(frames, **compensate_kwargs)

        return np.asarray(self.reference_frames)

    def _preregister_reference(self, frames, **compensate_kwargs):
        """Mean -> compensate each frame vs mean with alpha+2 -> mean."""
        from flowreg3d_tpu_torch.pipeline.compensate_arr import compensate_arr

        ref0 = frames.mean(axis=0)
        opts = self.replace(alpha=tuple(a + 2.0 for a in self.alpha),
                            reference_frames=ref0, cc_initialization=False,
                            preregister_reference=False)
        compensated, _ = compensate_arr(frames, ref0, options=opts,
                                        **compensate_kwargs)
        return compensated.mean(axis=0)

    # -- persistence --------------------------------------------------------

    def save_options(self, filepath=None) -> None:
        """Write the options as the JAX package does: a dated header line,
        then the fields as JSON (``constancy`` for constancy_assumption,
        enums as values, no ``preproc_funct``); an ndarray reference goes to
        ``reference_frames.tif`` beside the file, with its shape."""
        path = (Path(filepath) if filepath
                else self.output_path / "options.json")
        path.parent.mkdir(parents=True, exist_ok=True)
        data = {}
        for f in dataclasses.fields(self):
            if f.init and f.name not in _SCHEMA_EXCLUDED:
                data[_SCHEMA_ALIASES.get(f.name, f.name)] = getattr(
                    self, f.name)
        for k, v in list(data.items()):
            if isinstance(v, Path):
                data[k] = str(v)
            elif isinstance(v, np.ndarray):
                data[k] = v.tolist()
            elif isinstance(v, Enum):
                data[k] = v.value
        if isinstance(self.reference_frames, np.ndarray):
            from flowreg3d_tpu_torch.io._tiff_format import TiffWriter

            ref_path = path.parent / "reference_frames.tif"
            ref = self.reference_frames
            with TiffWriter(str(ref_path)) as tw:
                pages = ref if ref.ndim >= 3 else ref[np.newaxis]
                for page in pages.reshape(-1, *pages.shape[-2:]) \
                        if pages.ndim == 3 else pages.reshape(
                            -1, *pages.shape[-3:-1], pages.shape[-1]):
                    tw.write_page(page)
            data["reference_frames"] = str(ref_path)
            data["_reference_frames_shape"] = list(ref.shape)
        if isinstance(self.input_file, (np.ndarray, VideoReader3D)):
            data["input_file"] = None
        with path.open("w", encoding="utf-8") as f:
            f.write(f"Compensation options {date.today().isoformat()}\n\n")
            json.dump(data, f, indent=2, default=str)

    @classmethod
    def load_options(cls, filepath) -> "OFOptions":
        """Options from a file ``save_options`` (of either package) wrote."""
        p = Path(filepath)
        lines = p.read_text(encoding="utf-8").splitlines(keepends=True)
        start = next((i for i, ln in enumerate(lines)
                      if ln.strip().startswith("{")), 0)
        data = json.loads("".join(lines[start:]))
        shape = data.pop("_reference_frames_shape", None)
        ref = data.get("reference_frames")
        if isinstance(ref, str):
            rp = Path(ref)
            if rp.exists() and rp.suffix.lower() in (".tif", ".tiff"):
                arr = _read_tiff_pages(rp)
                if shape is not None:
                    arr = arr.reshape(shape)
                data["reference_frames"] = arr
        for name, alias in _SCHEMA_ALIASES.items():
            if alias in data:
                data[name] = data.pop(alias)
        return cls(**data)

    def to_dict(self) -> dict:
        """Solver kwargs for ``get_displacement``."""
        return {
            "alpha": self.alpha,
            "weight": self.weight,
            "levels": self.levels,
            "min_level": self.effective_min_level,
            "eta": self.eta,
            "iterations": self.iterations,
            "update_lag": self.update_lag,
            "a_data": self.a_data,
            "a_smooth": self.a_smooth,
            "const_assumption": self.constancy_assumption.value,
        }

    def __repr__(self) -> str:
        return (f"OFOptions(quality={self.quality_setting.value}, "
                f"alpha={self.alpha}, levels={self.levels}, "
                f"min_level={self.effective_min_level})")



def compensate_inplace(frames, reference, options=None, *, device=None,
                       config=None, **kwargs):
    """Compensate (T,Z,Y,X,C) frames against a reference in memory; returns
    (registered, flows). ``kwargs`` are option fields: they build the
    options when ``options`` is None, else replace its fields (not
    re-validated, as the JAX package's ``model_copy(update=...)``)."""
    from flowreg3d_tpu_torch.pipeline.compensate_arr import compensate_arr

    if options is None:
        options = OFOptions(**kwargs)
    elif kwargs:
        options = options.replace(**kwargs)
    return compensate_arr(frames, reference, options=options, config=config,
                          device=device)


# -- JSON schema (pydantic's model_json_schema, serialization mode) ----------

# field -> its JSON name (pydantic alias)
_SCHEMA_ALIASES = {"constancy_assumption": "constancy"}
# fields the schema leaves out (pydantic excludes them from serialization)
_SCHEMA_EXCLUDED = ("preproc_funct",)
# fields whose default is a factory in the JAX model: no default in the schema
_SCHEMA_FACTORY_DEFAULTS = ("reference_frames",)
# types pydantic cannot put in a JSON schema: left out of a union
_NON_JSON = (np.ndarray, VideoReader3D, VideoWriter3D)


def _type_schema(tp, defs):
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is Union:
        parts = [_type_schema(a, defs) for a in args
                 if a is not type(None) and a not in _NON_JSON]
        if type(None) in args:
            parts.append({"type": "null"})
        return parts[0] if len(parts) == 1 else {"anyOf": parts}
    if origin in (list, List):
        return {"items": _type_schema(args[0], defs), "type": "array"}
    if origin in (tuple, Tuple):
        items = [_type_schema(a, defs) for a in args]
        return {"maxItems": len(items), "minItems": len(items),
                "prefixItems": items, "type": "array"}
    if isinstance(tp, type) and issubclass(tp, Enum):
        defs[tp.__name__] = {"enum": [m.value for m in tp],
                             "title": tp.__name__, "type": "string"}
        return {"$ref": f"#/$defs/{tp.__name__}"}
    if tp is Any:
        return {}
    return {str: {"type": "string"}, int: {"type": "integer"},
            float: {"type": "number"}, bool: {"type": "boolean"},
            Path: {"format": "path", "type": "string"}}[tp]


def _json_default(v):
    if isinstance(v, Enum):
        return v.value
    if isinstance(v, Path):
        return str(v)
    if isinstance(v, (tuple, list)):
        return [_json_default(x) for x in v]
    return v


def get_mcp_schema() -> dict:
    """The options' JSON schema, as the JAX package's pydantic model gives
    it in serialization mode: properties with their types, defaults, bounds
    and titles, the enums under ``$defs``."""
    hints = typing.get_type_hints(OFOptions)
    defs, props = {}, {}
    for f in dataclasses.fields(OFOptions):
        if not f.init or f.name in _SCHEMA_EXCLUDED:
            continue
        prop = _type_schema(hints[f.name], defs)
        if "$ref" not in prop:
            prop["title"] = f.name.replace("_", " ").title()
        if f.name not in _SCHEMA_FACTORY_DEFAULTS:
            default = (f.default_factory()
                       if f.default is dataclasses.MISSING else f.default)
            prop["default"] = _json_default(default)
        if f.name in _INT_RANGES:
            prop["minimum"] = _INT_RANGES[f.name]
        if f.name in _FLOAT_RANGES:
            lo, lo_open, hi = _FLOAT_RANGES[f.name]
            prop["exclusiveMinimum" if lo_open else "minimum"] = lo
            if hi is not None:
                prop["maximum"] = hi
        if "description" in f.metadata:
            prop["description"] = f.metadata["description"]
        props[_SCHEMA_ALIASES.get(f.name, f.name)] = prop
    return {"$defs": dict(sorted(defs.items())),
            "additionalProperties": False,
            "description": OFOptions.__doc__, "properties": props,
            "title": "OFOptions", "type": "object"}
