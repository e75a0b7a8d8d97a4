"""Read the numbers that set a cell's limits, on the card at the cell's size.

    python portbench/calibrate.py --workload <cell> --seeds <s1,s2,...>
        [--control <s1,...>] [--items N] [--traffic JSON]

For each seed, in one process: the cell's inputs and warm-up as a run makes
them, the timed path once over the mix, and the numbers of ``lib/compare.py``
against the plain reference, as the entry's ``readings`` takes them
(``portbench/entries/<entry>.py``): the program's (the lower reading), and for
each ``--control`` seed also the control's: the plain reference in the
program's place with its matrix products in TF32 (operands rounded to TF32,
float32 accumulation), one precision below the configuration's float32 with
TF32 off (the upper reading). One JSON line a seed on standard output and in
``chiprun_out/calibrate_<cell>.jsonl``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--items", type=int, default=8)
    p.add_argument("--traffic", default="{}",
                   help="JSON object updating the traffic mix (a trial)")
    args = p.parse_args(argv)
    import torch

    from portbench.lib.spec import Spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA", file=sys.stderr)
        return 2
    spec = Spec()
    wl = spec.workload(args.workload)
    cfg, tr = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    tr.update(json.loads(args.traffic))
    mod = spec.entry(tr["entry"])
    control = {int(s) for s in args.control.split(",") if s}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    dev = torch.device("cuda", 0)
    with open(out_dir / f"calibrate_{args.workload}.jsonl", "a") as log:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            entry = mod.Entry(cfg, tr, seed, dev)
            entry.setup()
            readings = mod.readings(entry, seed in control, args.items)
            line = json.dumps(dict(workload=args.workload, seed=seed,
                                   traffic=json.loads(args.traffic),
                                   readings=readings[0], info=readings[1],
                                   seconds=time.perf_counter() - t,
                                   card=torch.cuda.get_device_name(0)))
            print(line, flush=True)
            log.write(line + "\n")
            del entry
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
