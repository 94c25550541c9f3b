"""utils/ledger.py: rows are merged by key under study@platform:kind."""

import json

import jax

from ipde_tpu.utils.ledger import record


def test_record_merges_rows_per_device(tmp_path):
    path = str(tmp_path / "LEDGER.json")
    record("study", [{"nb": 200, "err": 1e-4}, {"nb": 600, "err": 1e-7}],
           ("nb",), path=path)
    block = record("study", [{"nb": 600, "err": 5e-8}], ("nb",), path=path)
    dev = jax.devices()[0]
    with open(path) as fh:
        ledger = json.load(fh)
    key = f"study@{dev.platform}:{dev.device_kind}"
    assert list(ledger) == [key]
    assert ledger[key]["device_kind"] == dev.device_kind
    assert block["rows"] == [{"nb": 200, "err": 1e-4},
                             {"nb": 600, "err": 5e-8}]
