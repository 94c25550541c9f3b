"""Append-only refinement ledger (LEDGER.json at the repo root).

`record()` keys each block by (study, platform, device kind) and merges
rows by the study's key fields: re-running nb=300 refreshes the nb=300 row
and leaves nb=1200 in place.  A block only ever grows or refreshes.
"""

from __future__ import annotations

import json
import os
import time


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def record(study: str, rows: list, key_fields: tuple, path: str = None):
    """Merge `rows` into LEDGER.json under "<study>@<platform>:<kind>".

    key_fields: row keys identifying a configuration (e.g. ("nb", "M")).
    Rows with a key tuple matching an existing row replace it; all other
    existing rows are retained.  Returns the merged block.
    """
    import jax
    dev = jax.devices()[0]
    path = path or os.path.join(_repo_root(), "LEDGER.json")
    ledger = {}
    if os.path.exists(path):
        with open(path) as fh:
            ledger = json.load(fh)
    block_key = f"{study}@{dev.platform}:{dev.device_kind}"
    old_rows = ledger.get(block_key, {}).get("rows", [])
    new_keys = {tuple(r.get(k) for k in key_fields) for r in rows}
    merged = [r for r in old_rows
              if tuple(r.get(k) for k in key_fields) not in new_keys] + rows

    def sort_key(r):
        return tuple((v is None, v) for v in
                     (r.get(k) for k in key_fields))
    merged.sort(key=sort_key)
    ledger[block_key] = {"rows": merged, "platform": dev.platform,
                         "device_kind": dev.device_kind,
                         "date": time.strftime("%Y-%m-%d")}
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(ledger, fh, indent=1)
    os.replace(tmp, path)
    return ledger[block_key]
