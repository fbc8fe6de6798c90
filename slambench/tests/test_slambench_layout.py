"""The benchmark's files and how the harness finds them by name."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from slambench.core import guard, registry

BENCH = registry.load_benchmark()
ROOT = registry.BENCH_ROOT


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = registry.resolve(cell, BENCH)
    assert c.config_name == cell.split(".")[0]
    assert callable(registry.load_driver(c).run)
    assert callable(registry.load_driver(c).control)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.traffic["limits"]) and all(
        isinstance(v, float) for v in c.traffic["limits"].values())


def test_every_file_parses_and_every_metric_has_a_reader():
    for path in list((ROOT / "configs").glob("*.json")) + list(
            (ROOT / "traffic").glob("*.json")):
        json.loads(path.read_text())
    readers = registry.load_metric_readers()
    assert {m["name"] for m in BENCH["per_layer"]} == set(readers)
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} \
            if "moves" in m else m["bound"] <= 0.25


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    """A throwaway traffic mix (on an existing driver) and a throwaway
    metric, added as new files and entries in a copy, are found with no
    edit to any file that was there."""
    repo = tmp_path / "repo"
    shutil.copytree(ROOT, repo / "slambench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (repo / "slambench").rglob("*")
              if p.is_file()}
    traffic = json.loads((ROOT / "traffic" / "label_b8.json").read_text())
    traffic["batch"] = 1
    (repo / "slambench" / "traffic" / "label_b1.json").write_text(
        json.dumps(traffic))
    (repo / "slambench" / "metrics" / "host_share.py").write_text(
        textwrap.dedent('''
            NAME = "host_share.segnet"

            def read(trace, cell):
                return 42.0
        '''))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "segnet_camvid.label_b1",
                               "config": "segnet_camvid",
                               "traffic": "label_b1", "chips": 1,
                               "why": "batch 1"})
    bench["per_layer"].append({"name": "host_share.segnet", "unit": "%",
                               "better": "lower", "source": "host_clock",
                               "layer": "device",
                               "moves": "label_images_per_s",
                               "workloads": ["segnet_camvid.label_b1"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.resolve("segnet_camvid.label_b1", bench, repo=repo,
                            root=repo / "slambench")
    assert cell.traffic["batch"] == 1
    assert registry.load_driver(cell, repo / "slambench").__name__ \
        .endswith("segnet_label")
    readers = registry.load_metric_readers(repo / "slambench")
    assert readers["host_share.segnet"](None, cell) == 42.0
    assert [m["name"] for m in cell.per_layer][-1] == "host_share.segnet"
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_nothing_the_benchmark_runs_loads_jax():
    """Import ``run.py``'s runner, every driver and every metric reader in
    a fresh interpreter, and look at ``sys.modules`` by whole top-level
    names."""
    code = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(ROOT.parent)!r})
        from slambench.core import guard, registry, runner
        bench = registry.load_benchmark()
        for w in bench["workloads"]:
            registry.load_driver(registry.resolve(w["name"], bench))
        registry.load_metric_readers()
        import slambench.tests.controls, slambench.tests.faults
        print(guard.forbidden_loaded())
        print(sorted({{n.split(".")[0] for n in sys.modules}}))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    found, tops = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "semantic_slam_mapping_torch" in tops
    assert "semantic_slam_mapping_tpu" not in tops


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["jax.numpy", "semantic_slam_mapping_tpu"
                                   ".ops", "jaxtyping", "flaxen",
                                   "semantic_slam_mapping_torch.ops"]) == [
        "jax.numpy", "semantic_slam_mapping_tpu.ops"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").glob("*.py"):
        tops = guard.imported_top_levels(path)
        assert guard.PORT not in tops, path
        assert not tops & guard.FORBIDDEN, path
