"""Cells, engines and metrics found by name; a new cell added as files
alone; the refusal to run without a card; the whole-name module check."""

import json
import os
import sys

import pytest

from svbench import harness, run

CELLS = ("sr1kg.geno", "ont.cons", "sr1kg.asm")


def test_benchmark_names_files_that_exist(bench):
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(harness.REPO, c["file"]))
    for w in bench["workloads"]:
        cell, config = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] == config["name"]
        assert cell["traffic"] == w["traffic"]
        harness.engine_class(cell["engine"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_metrics_for_a_cell(bench):
    e2e = [m["name"] for m in harness.metrics_for(bench, "ont.cons", False)]
    assert e2e == ["gcups", "setup_s"]
    layer = [m["name"] for m in harness.metrics_for(bench, "ont.cons", True)]
    assert "roofline.k1" in layer and "roofline.k2" not in layer
    layer = [m["name"] for m in harness.metrics_for(bench, "sr1kg.asm", True)]
    assert {"roofline.x1", "roofline.k2", "roofline.k2tb"} <= set(layer)
    assert "idle_share.msa" in layer and "idle_share" not in layer
    e2e = [m["name"] for m in harness.metrics_for(bench, "sr1kg.asm", False)]
    assert e2e == ["gcups.msa", "setup_s"]


def test_each_layer_metric_moves_a_metric_of_its_cells(bench):
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in harness.metrics_for(bench, cell, False)}
            assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_on_the_host(name, trace, tiny_root, cpu, bench):
    out = harness.run(name, 2**32 + 3, 0.05, trace, cpu, bench,
                      root=tiny_root)
    res = out["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(out["checks"]) and all(v == 0 for v, _l
                                      in out["checks"].values())
    want = {m["name"] for m in harness.metrics_for(bench, name, trace)}
    if not trace:
        assert set(res["metrics"]) == want and "setup_s" in want
    else:
        host = {"wrapper_host_ms", "batch_p95_ms", "launches_per_batch"}
        if name == "sr1kg.asm":
            host = {k + ".msa" for k in host}
        assert host <= set(res["metrics"]) <= want
        # no card: nothing for a device metric to read
        assert not any(k.startswith("roofline") or k == "idle_share"
                       for k in res["metrics"])


def test_a_new_cell_is_files_alone(tiny_root, cpu, bench):
    cell = harness.load_json(os.path.join(tiny_root, "workloads",
                                          "sr1kg.geno.json"))
    cell.update({"mode": "NW", "traffic": "geno_nw", "jobs_per_batch": 16})
    with open(os.path.join(tiny_root, "workloads", "sr1kg.geno_nw.json"),
              "w") as fh:
        json.dump(cell, fh)
    with open(os.path.join(tiny_root, "metrics", "pairs_per_batch.py"),
              "w") as fh:
        fh.write("def read(rec):\n    return 32.0\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "sr1kg.geno_nw", "config":
                               "sr-1kgp-2x100", "traffic": "geno_nw",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "pairs_per_batch", "unit": "pairs",
                               "better": "higher", "source":
                               "program_counter", "layer": "dispatch",
                               "moves": "gcups",
                               "workloads": ["sr1kg.geno_nw"]})
    out = harness.run("sr1kg.geno_nw", 5, 0.05, True, cpu, bench,
                      root=tiny_root)
    assert out["result"]["correct"]
    assert out["result"]["metrics"]["pairs_per_batch"]["value"] == 32.0


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sr1kg.geno", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "No result" in out.err


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "delly_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "delly_tpu.ops.fake", object())
    monkeypatch.setitem(sys.modules, "jax_fake", object())
    assert run.forbidden_modules() == ["delly_tpu.ops.fake"]
