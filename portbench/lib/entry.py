"""What every entry shares. An entry is the code a traffic mix drives:
``portbench/entries/<name>.py``, found by the mix's ``"entry"`` key
(``Spec.entry``). Its module defines

- ``Entry``, a subclass of ``lib.entry.Entry``: ``setup()`` makes the inputs
  from the seed and warms up the shapes its window uses; ``window(seconds,
  traced)`` drives the program back to back and returns (items, seconds,
  per-item or per-call seconds); ``e2e(items, seconds, times)`` the
  end-to-end quantities of that window by name; ``traced_slice()`` profiles a
  bounded slice and returns (``lib.trace.Slice``, items); ``release()`` frees
  the program's state; ``check(mm)`` the numbers of ``lib/compare.py``
  against the plain reference;
- ``readings(entry, control, items)``, for ``calibrate.py``: the program's
  numbers and, with ``control``, the control's, as ({name: numbers}, info).

The entry counts ``attempted`` and ``failed`` and keeps its host-clock spans
in ``spans``.
"""

import numpy as np
import torch

from portbench.reference import plain

SOLVER_KEYS = ("alpha", "iterations", "update_lag", "min_level", "levels",
               "eta", "a_smooth", "a_data")


def solver_params(flow):
    """The solver's parameters of a configuration's flow options."""
    return {k: flow[k] for k in SOLVER_KEYS}


def check_sample(seed, ranges, per_batch):
    """The frames a recording's check compares: ``per_batch`` distinct frames
    of every batch, drawn from the seed."""
    rng = np.random.default_rng(seed % (1 << 63))
    return sorted(int(t) for a, b in ranges
                  for t in rng.choice(np.arange(a, b), min(per_batch, b - a),
                                      replace=False))


class Entry:
    """Shared state: the configuration, the traffic, the seed, the device
    and what the window counted."""

    labels = ()
    item = "items"

    def __init__(self, config, traffic, seed, device):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.shape = tuple(config["shape"])
        self.channels = int(config["channels"])
        self.flow = config["flow"]
        self.params = solver_params(self.flow)
        self.attempted = 0
        self.failed = 0
        self.spans = {}

    def notes(self):
        """What the program reports of the warm-up, for the run's log."""
        return ""

    def registration(self):
        """The ``RegistrationConfig`` keywords of the configuration and then
        the traffic (``"registration"`` in either file), or None for the
        default config."""
        kw = dict(self.config.get("registration", {}),
                  **self.traffic.get("registration", {}))
        return kw or None

    def plan(self):
        return plain.level_schedule(self.shape, self.params["eta"],
                                    self.params["levels"],
                                    self.params["min_level"])[0]

    def release(self):
        from flowreg3d_tpu_torch.parallel.executors import clear_frame_graphs

        clear_frame_graphs()
        torch.cuda.empty_cache()
