"""Runtime context: capability detection, registries, scoped overrides.

Counterpart of ``flowreg3d_tpu/runtime.py``: a process-global config dict
with contextvar overrides and a ``use()`` context manager, detection of the
available flow backends, executors, features and devices, the executor
lookup by name (the reference's names as aliases), the flow-backend
registry, and an env-var snapshot (JSON under ``FLOWREG3D_TORCH_CONTEXT``,
a key of the port's own, so that the two packages' snapshots cannot meet in
one process) for child processes.

Features report torch, its CUDA build, whether a card is visible and
whether the CUDA kernels of ``csrc/`` are built; devices come from
``torch.cuda`` (the CPU counts as one device when there is no card), the
process index and count from ``torch.distributed`` when its process group
is initialised (``parallel/multihost.initialize``).
"""

import contextvars
import inspect
import json
import os
from contextlib import contextmanager

_ENV_KEY = "FLOWREG3D_TORCH_CONTEXT"
_overrides = contextvars.ContextVar("flowreg3d_tpu_torch_overrides",
                                    default=None)

# -- flow-backend registry ---------------------------------------------------
# A backend is a factory returning a callable with the get_displacement
# protocol ``fn(fixed, moving, uvw=..., **params) -> (Z,Y,X,3)`` that
# replaces the variational solver inside the executors
# (``RegistrationConfig(flow_backend=name)``; ``backends/volraft.py``
# registers 'volraft' and 'volraft-mock' when imported).
_FLOW_BACKENDS = {}


def register_flow_backend(name, factory):
    """Register a displacement-backend factory under ``name``."""
    _FLOW_BACKENDS[str(name)] = factory


def get_flow_backend(name, **kwargs):
    """Instantiate a registered backend; raises KeyError with choices.
    ``kwargs`` (the pipeline passes ``device`` and ``use_kernels``) go to
    the factory where its signature takes them."""
    try:
        factory = _FLOW_BACKENDS[str(name)]
    except KeyError:
        raise KeyError(
            f"Unknown flow backend '{name}'. Registered: "
            f"{sorted(_FLOW_BACKENDS)}") from None
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        params = {}
    if not any(p.kind is p.VAR_KEYWORD for p in params.values()):
        kwargs = {k: v for k, v in kwargs.items() if k in params}
    return factory(**kwargs)


def list_flow_backends():
    return sorted(_FLOW_BACKENDS)


class RuntimeContext:
    """Process-global runtime configuration with contextvar overrides."""

    _config = {}
    _initialized = False

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def init(cls, force=False):
        if cls._initialized and not force:
            return cls._config
        cls._config = {
            "available_backends": cls._detect_backends(),
            "available_parallelization": cls._detect_parallelization(),
            "features": cls._detect_features(),
            "devices": cls._detect_devices(),
        }
        env = os.environ.get(_ENV_KEY)
        if env:
            try:
                cls._config.update(json.loads(env))
            except json.JSONDecodeError:
                pass
        cls._initialized = True
        return cls._config

    # -- detection ----------------------------------------------------------

    @staticmethod
    def _detect_backends():
        backends = {"variational"}
        for name, module in (("torch", "torch"),
                             ("raft-2p", "raft2p"),
                             ("flownet2", "flownet2"),
                             ("pwcnet", "pwcnet"),
                             ("deepflow", "deepflow")):
            try:
                __import__(module)
                backends.add(name)
            except ImportError:
                pass
        backends.update(_FLOW_BACKENDS)
        return sorted(backends)

    @staticmethod
    def _detect_parallelization():
        from flowreg3d_tpu_torch.parallel.executors import list_executors

        modes = list(list_executors())
        for name in ("dask", "ray"):
            try:
                __import__(name)
                modes.append(name)
            except ImportError:
                pass
        return modes

    @staticmethod
    def _detect_features():
        import torch

        from flowreg3d_tpu_torch import _ext

        return {"torch": torch.__version__,
                "cuda": torch.version.cuda,
                "cuda_available": torch.cuda.is_available(),
                "kernels_built": _ext.library_path().exists()}

    @staticmethod
    def _detect_devices():
        import torch

        dist = torch.distributed
        pi, pc = ((dist.get_rank(), dist.get_world_size())
                  if dist.is_available() and dist.is_initialized()
                  else (0, 1))
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            return {"platform": "cuda", "n_devices": n,
                    "names": [torch.cuda.get_device_name(i)
                              for i in range(n)],
                    "process_index": pi, "n_processes": pc}
        return {"platform": "cpu", "n_devices": 1, "names": ["cpu"],
                "process_index": pi, "n_processes": pc}

    # -- access -------------------------------------------------------------

    @classmethod
    def get(cls, key, default=None):
        cls.init()
        ov = _overrides.get()
        if ov and key in ov:
            return ov[key]
        return cls._config.get(key, default)

    @classmethod
    def set(cls, key, value):
        cls.init()
        cls._config[key] = value

    @classmethod
    @contextmanager
    def use(cls, **kwargs):
        """Scoped overrides: ``with RuntimeContext.use(executor='batched'):``"""
        cls.init()
        merged = dict(_overrides.get() or {})
        merged.update(kwargs)
        token = _overrides.set(merged)
        try:
            yield cls
        finally:
            _overrides.reset(token)

    # -- executor registry --------------------------------------------------

    @classmethod
    def get_parallelization_executor(cls, name):
        """The executor class registered under ``name`` or its alias; None
        for an unknown name."""
        from flowreg3d_tpu_torch.parallel.executors import (_ALIASES,
                                                            _EXECUTORS)

        return _EXECUTORS.get(name) or _EXECUTORS.get(_ALIASES.get(name,
                                                                    name))

    # -- transport ----------------------------------------------------------

    @classmethod
    def snapshot(cls):
        cls.init()
        snap = dict(cls._config)
        snap.update(_overrides.get() or {})
        return snap

    @classmethod
    def to_env(cls):
        """Serialize the context into the child-process environment."""
        os.environ[_ENV_KEY] = json.dumps(cls.snapshot(), default=str)

    @classmethod
    def from_env(cls):
        cls.init(force=True)
        return cls._config


def get_optimal_parallelization(n_frames=None, volume_voxels=None):
    """Heuristic executor choice: 'mesh' on more than one device;
    'sequential' for single huge volumes (bounded device memory); else
    'batched'."""
    if RuntimeContext.get("devices", {}).get("n_devices", 1) > 1:
        return "mesh"
    if volume_voxels is not None and volume_voxels > 3e8:
        return "sequential"
    return "batched"
