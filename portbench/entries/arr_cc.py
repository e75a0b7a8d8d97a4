"""``arr``'s in-memory pipeline under the cc prealignment: the configuration's
flow options carry ``cc_initialization``, so ``compensate_arr_3D`` prealigns
every frame by phase correlation, solves the residual from zero and re-warps
it, on the host-staged engine. The mix's keys are ``arr``'s; only the check
differs: the reference's frames are ``reference/prealign.check_frames_cc``'s.
"""

from portbench.entries import arr
from portbench.reference import plain
from portbench.reference.prealign import check_frames_cc


class Entry(arr.Entry):
    """The in-memory pipeline over one recording, cc prealigned."""

    def reference_frames(self, flows, mm=plain.fp32_matmul):
        """The reference's (total flow, registered) of each sampled
        frame."""
        fl = self.flow
        return check_frames_cc(
            self.frames, self.reference, flows, self.sample(), self.params,
            fl["weight"], fl["sigma"], int(fl["buffer_size"]), self.device,
            mm, tuple(fl["cc_hw"]), int(fl["cc_up"]))


readings = arr.readings
