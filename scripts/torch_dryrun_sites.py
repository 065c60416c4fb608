#!/usr/bin/env python3
"""Where a dry-run step's collective bytes come from: each kind's bytes per
rank by site, for one (architecture, shape) pair traced on a fake group.

    PYTHONPATH=src python3 scripts/torch_dryrun_sites.py \
        --arch deepseek-r1 --shape train            # 2 x 4, smoke width
    PYTHONPATH=src python3 scripts/torch_dryrun_sites.py \
        --arch deepseek-r1 --shape train_4k --production   # 16 x 16

At smoke width (the default) the pair is ``smoke_variant(arch)`` at
``BATCH`` rows of ``SEQ`` tokens (the smoke pairs of
``tests/test_torch_dryrun.py``), ``--shape`` a kind (``train``,
``decode``, ``prefill``), on a fake ``--mesh`` (data x model, 2 x 4); with
``--production`` it is the whole config at a shape of ``INPUT_SHAPES`` on
the fake 16 x 16 group. It runs ``launch/dryrun.py``'s ``_measure`` under
a counter that tags every collective with its site: the innermost frame
of ``repro_torch`` on the stack (``file:line``; in the helpers of
``dtensor.py`` and ``core/parallel.py``, with the innermost caller outside
them), or, for one that the autograd engine issues in the backward,
``autograd <-`` the forward line and the node whose backward issued it
(anomaly mode keeps the forward's traceback). Prints one line per site, the
largest first, then one JSON line ``{"sites": {site: {kind: bytes}},
"totals": {kind: bytes}}``; the sites sum to the totals. Shapes only: no
card is needed, and none is used.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))

PORT = str(HERE / "src" / "repro_torch") + "/"


#: rows and tokens of a smoke pair
BATCH, SEQ = 8, 64

#: modules of helpers whose callers name the site too
HELPERS = ("dtensor.py", "core/parallel.py")


def _ours(frames):
    """``path:line`` under the package of the frames of ``repro_torch``
    among ``frames`` ((filename, line), the innermost last)."""
    return [f"{name[len(PORT):]}:{line}" for name, line in frames
            if name.startswith(PORT)
            and not name.endswith("launch/collectives.py")]


def _named(ours) -> str:
    """The innermost of ``ours``, followed by ``< `` the innermost outside
    the helper modules when that one is in them; '' for none."""
    if not ours:
        return ""
    caller = next((f for f in reversed(ours)
                   if not f.startswith(HELPERS)), None)
    if ours[-1].startswith(HELPERS) and caller:
        return f"{ours[-1]} < {caller}"
    return ours[-1]


def site_of_stack() -> str:
    """The innermost frame of ``repro_torch`` on the stack (with its caller
    outside the helpers); in the backward, the forward line of the node
    being run (the traceback that anomaly mode keeps): ``autograd <-``
    that line and the node where DTensor's own backward rules issue the
    collective, else the port's frame that issues it ``(backward) <-``
    that line."""
    import torch

    frames, frame = [], sys._getframe(2)
    while frame is not None:
        frames.append((frame.f_code.co_filename, frame.f_lineno))
        frame = frame.f_back
    ours = _ours(frames[::-1])
    node = torch._C._current_autograd_node()
    if node is None:
        return _named(ours) or "?"
    fwd = _named(_ours(_traceback(node.metadata.get("traceback_", []))))
    if not ours or ours[-1].startswith("train/"):
        return f"autograd <- {fwd or '?'} {node.name()}"
    return f"{ours[-1]} (backward) <- {fwd or '?'}"


def _traceback(tb):
    """(filename, line) of each entry of a node's forward traceback (as
    ``traceback.format_stack`` prints them)."""
    import re

    out = []
    for entry in tb:
        m = re.match(r'\s*File "([^"]+)", line (\d+)', entry)
        if m:
            out.append((m.group(1), int(m.group(2))))
    return out


def measure_sites(cfg, shape, mesh):
    """(sites, totals) of one traced step: ``{site: {kind: bytes}}`` and
    the counter's totals by kind."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.collectives import KIND

    sites = defaultdict(lambda: defaultdict(int))

    class SiteCounter(dryrun.StepCounter):
        """Each op's increase of the counts goes to its site."""

        def record(self, func, args, kwargs, out):
            if func._schema.name in KIND:
                kind = KIND[func._schema.name]
                seen = sum(by.get(kind, 0) for by in sites.values())
                sites[site_of_stack()][kind] += self.counts[kind] - seen
            super().record(func, args, kwargs, out)

    real = dryrun.StepCounter
    dryrun.StepCounter = SiteCounter
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=False):
            got = dryrun._measure(cfg, shape, mesh)
    finally:
        dryrun.StepCounter = real
    return {s: dict(k) for s, k in sites.items()}, got["coll"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    help="a kind at smoke width; a shape name with "
                         "--production")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--mesh", default="2x4", help="data x model at smoke "
                    "width")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_shape, smoke_variant
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION_SHAPE

    if args.production:
        cfg, shape = get_config(args.arch), get_shape(args.shape)
        mesh = dryrun.fake_mesh(PRODUCTION_SHAPE)
    else:
        cfg = smoke_variant(get_config(args.arch))
        shape = InputShape("p", SEQ, BATCH, args.shape)
        data, model = (int(n) for n in args.mesh.split("x"))
        mesh = dryrun.fake_mesh({"data": data, "model": model})
    sites, totals = measure_sites(cfg, shape, mesh)
    kinds = [k for k in totals if k != "count"]
    print(f"{'site':44s} " + " ".join(f"{k:>18s}" for k in kinds))
    for site, by in sorted(sites.items(), key=lambda kv: -sum(kv[1].values())):
        print(f"{site:44s} " + " ".join(f"{by.get(k, 0):18,d}"
                                         for k in kinds))
    print(f"{'total':44s} " + " ".join(f"{totals[k]:18,d}" for k in kinds))
    print(json.dumps({"sites": sites, "totals": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
