"""``python -m xgboost_tpu_torch.obs``: the observability CLI (the port
of the JAX package's ``obs/__main__.py``, with its exit codes).

Subcommands:

- ``postmortem <bundle.json> [...]``: CRC-verify and render black-box
  bundles (written by :mod:`~.flight` at an abnormal exit, or by the
  pipeline's chaos harness at a kill). Exit 1 when any bundle is missing
  or corrupt.
- ``merge <ring.json> [...] -o merged.json``: merge per-rank flight rings
  into one clock-aligned Perfetto timeline.
"""

from __future__ import annotations

import argparse
import json
import sys

from .flight import BundleCorrupt, merge_rings, render_postmortem, \
    verify_bundle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m xgboost_tpu_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("postmortem", help="render black-box bundles")
    pm.add_argument("bundles", nargs="+")
    mg = sub.add_parser("merge", help="merge per-rank rings into one "
                                      "Perfetto timeline")
    mg.add_argument("rings", nargs="+")
    mg.add_argument("-o", "--out", default="xtpu_merged_trace.json")
    args = ap.parse_args(argv)

    if args.cmd == "postmortem":
        bad = 0
        for path in args.bundles:
            try:
                doc = verify_bundle(path)
            except BundleCorrupt as e:
                print(f"CORRUPT: {e}", file=sys.stderr)
                bad += 1
                continue
            print(f"== {path}")
            render_postmortem(doc)
        return 1 if bad else 0

    if args.cmd == "merge":
        merged = merge_rings(args.rings)
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(merged, fh)
        n = sum(1 for ev in merged["traceEvents"] if ev.get("ph") == "X")
        print(f"wrote {args.out}: {n} spans, "
              f"{len(args.rings)} rank tracks")
        return 0

    return 2  # pragma: no cover - argparse enforces the subcommands


if __name__ == "__main__":
    sys.exit(main())
