"""CLI root of the port, the ``flowreg3d-torch`` console script
(counterpart of ``flowreg3d_tpu/cli/main.py``; parity: reference
cli/main.py:25-87).

Subcommands: ``tiff-reshape`` (flat TIFF -> proper 3D volumetric stack) and
``concat-tiffs`` (folder of per-timepoint volumes -> one TZYXC movie). Their
``--scale`` resize runs on ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path).
"""

import argparse
import sys
import traceback


def _version():
    try:
        from importlib.metadata import version

        return version("flowreg3d-tpu")
    except Exception:
        try:
            from flowreg3d_tpu_torch import __version__

            return __version__
        except Exception:
            return "unknown"


def build_parser():
    parser = argparse.ArgumentParser(
        prog="flowreg3d-torch",
        description="flowreg3d-tpu's PyTorch port: 3D motion correction "
                    "tools",
    )
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {_version()}")
    subparsers = parser.add_subparsers(dest="command", metavar="COMMAND")

    from flowreg3d_tpu_torch.cli.tiff_reshape import add_parser as add_reshape
    from flowreg3d_tpu_torch.cli.concat_tiffs import add_parser as add_concat

    add_reshape(subparsers)
    add_concat(subparsers)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 1
    try:
        return args.func(args) or 0
    except KeyboardInterrupt:
        print("\nInterrupted.", file=sys.stderr)
        return 130
    except Exception as e:
        if getattr(args, "verbose", False):
            traceback.print_exc()
        else:
            print(f"Error: {e}", file=sys.stderr)
            print("Run with --verbose for the full traceback.",
                  file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
