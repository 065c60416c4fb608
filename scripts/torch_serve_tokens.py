#!/usr/bin/env python3
"""Whether a change moved any served token: runs a tree's ``chip_smoke.py``
on the card with every ``ServingSystem.serve`` call of the run recorded,
and prints, after each, one line

    serve-tokens: {"call": i, "requests": n, "tokens": t, "sha256": "...",
                   "trace_sha256": "..."}

(the SHA-256 of the served tokens by request id, in request order, and of
the scheduler's per-request trace records; the serves of the CLI phases
included), beside ``chip_smoke.py``'s own lines. With ``--traces FILE``
each call's trace records are also appended to FILE as one JSON line.
Run it over two trees on one card, one after the other, and compare the
lines:

    python3 scripts/torch_serve_tokens.py [TREE] [--traces FILE]

``TREE`` is a checkout of the repo (``git archive`` unpacked under the
gitignored ``experiments/``; default: this checkout). It needs one GPU,
as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True,
                                     default=str).encode()).hexdigest()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--traces", default=None)
    opts = ap.parse_args(argv)
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.serving import engine

    real, calls = engine.ServingSystem.serve, []

    def serve(self, *args, **kwargs):
        results = real(self, *args, **kwargs)
        toks = [[int(t) for t in r.tokens]
                for r in sorted(results, key=lambda r: r.rid)]
        traces = self.scheduler.trace_records()
        calls.append(_sha(toks))
        print("serve-tokens: " + json.dumps({
            "call": len(calls), "requests": len(toks),
            "tokens": sum(map(len, toks)), "sha256": calls[-1],
            "trace_sha256": _sha(traces)}), flush=True)
        if opts.traces:
            with open(opts.traces, "a") as f:
                f.write(json.dumps(traces, sort_keys=True, default=str)
                        + "\n")
        return results

    engine.ServingSystem.serve = serve
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    return smoke.main([])


if __name__ == "__main__":
    sys.exit(main())
