"""Command-line interface (counterpart of cfd_julia_tpu/cli.py; the `run`
subcommand so far).

    python -m cfd_julia_torch run <preset> [--outdir DIR] [--device cuda|cpu]
                                  [--checkpoint-every N] [--resume]
                                  [--nx N] [--t_final X] ...

`run` accepts any config dataclass field of the preset as a --key value
override, e.g. `run cavity --poisson fused_bf16x3` for a precision tier of
the cavity's Poisson products (matmul_bf16x3 | matmul_bf16x1 |
fused_bf16x3 | fused_bf16x1: the TPU's split-bf16 arithmetic on every
device, the CUDA kernel on a GPU and its plain twin on the CPU; fp32, the
runs' default dtype).  --device defaults to cuda and raises without a GPU;
a CPU run says --device cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _parse_value(field_type, raw: str):
    """Parse a CLI override honoring the declared dataclass field type
    (string annotations under `from __future__ import annotations`):
    a str-typed field keeps "32" as a string, an int/float field parses
    numerically; untyped falls back to inference."""
    tname = field_type if isinstance(field_type, str) else \
        getattr(field_type, "__name__", "")
    if tname == "str":
        return raw
    if tname == "bool":
        return raw.lower() in ("1", "true", "yes", "on")
    if tname == "int":
        try:
            return int(raw)
        except ValueError:
            f = float(raw)         # accept integral "1e5" / "2.0"
            if f != int(f):
                raise ValueError(
                    f"{raw!r} is not an integer value") from None
            return int(f)
    if tname == "float":
        return float(raw)
    for cast in (int, float):
        try:
            v = cast(raw)
            if cast is int and "." in raw:
                continue
            return v
        except ValueError:
            continue
    return raw


def cmd_run(args, extra):
    from cfd_julia_torch import presets, run

    preset = presets.get(args.preset)
    overrides = {}
    fields = {f.name: f for f in dataclasses.fields(preset.cfg)}
    i = 0
    while i < len(extra):
        key = extra[i].lstrip("-")
        if key not in fields:
            print(f"unknown override --{key} for preset {args.preset}; "
                  f"fields: {', '.join(fields)}", file=sys.stderr)
            return 2
        if i + 1 >= len(extra):
            print(f"override --{key} needs a value", file=sys.stderr)
            return 2
        try:
            overrides[key] = _parse_value(fields[key].type, extra[i + 1])
        except ValueError as e:
            print(f"override --{key}: {e}", file=sys.stderr)
            return 2
        i += 2

    metrics = run.run_preset(args.preset, outdir=args.outdir,
                             device=args.device,
                             checkpoint_every=args.checkpoint_every,
                             resume=args.resume, **overrides)
    print(json.dumps(metrics, indent=2))
    return 0


def main(argv=None):
    # allow_abbrev=False: prefix matching would take "--re 100" as an
    # abbreviation of a flag
    parser = argparse.ArgumentParser(prog="cfd_julia_torch",
                                     allow_abbrev=False)
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", allow_abbrev=False)
    pr.add_argument("preset")
    pr.add_argument("--outdir", default="out")
    pr.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises "
                         "without a GPU — a CPU run says --device cpu)")
    pr.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="N", dest="checkpoint_every",
                    help="save a resumable checkpoint to "
                         "OUTDIR/checkpoint.npz every N steps (cavity and "
                         "vortex families)")
    pr.add_argument("--resume", action="store_true",
                    help="continue from OUTDIR/checkpoint.npz if present")

    args, extra = parser.parse_known_args(argv)
    return cmd_run(args, extra)


if __name__ == "__main__":
    sys.exit(main())
