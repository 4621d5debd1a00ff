"""What the resumable pipelines share: a stage runs unless its completion
marker <out>/.done_<stage> exists (or --force), and records its numbers
under its name in <out>/summary.json."""

from __future__ import annotations

import json
import os


def marker(out: str, stage: str) -> str:
    return os.path.join(out, f".done_{stage}")


def pending(out: str, stage: str, force: bool) -> bool:
    return force or not os.path.exists(marker(out, stage))


def summary_path(out: str) -> str:
    return os.path.join(out, "summary.json")


def load_summary(out: str) -> dict:
    path = summary_path(out)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def finish(out: str, summary: dict, stage: str, record: dict) -> None:
    """Store the stage's record in summary.json, write its marker and print
    its JSON line."""
    summary[stage] = record
    with open(summary_path(out), "w") as f:
        json.dump(summary, f, indent=1)
    with open(marker(out, stage), "w") as f:
        f.write("ok")
    print(json.dumps({"stage": stage, **record}, default=str), flush=True)
