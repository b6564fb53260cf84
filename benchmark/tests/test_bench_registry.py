"""The harness finds configurations, traffic mixes and metrics by name."""
import json
import shutil
from pathlib import Path

from benchmark import harness

ROOT = Path(harness.ROOT)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix and a metric that exist only as new
    files plus entries in BENCHMARK.json are found without an edit to any
    file that was there."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    (tmp_path / "benchmark/configs/tiny-new.json").write_text(json.dumps({"plm": {"n_layers": 1}}))
    (tmp_path / "benchmark/traffic/new-mix.json").write_text(json.dumps({"runner": "train", "batch": 3}))
    (tmp_path / "benchmark/metrics/new_metric.x.py").write_text(
        "def read(rec):\n    return rec['steps'] * 2\n")
    (tmp_path / "benchmark/metrics/never_here.py").write_text("def read(rec):\n    return None\n")
    bench["configs"].append({"name": "tiny-new", "source": "https://example.org", "reduced": [],
                             "file": "benchmark/configs/tiny-new.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny-new.new-mix", "config": "tiny-new",
                               "traffic": "new-mix", "chips": 1, "why": "a test"})
    bench["per_layer"] += [
        {"name": "new_metric.x", "unit": "1", "better": "higher", "source": "host_clock",
         "layer": "train step", "moves": "train_step_ms", "workloads": ["tiny-new.new-mix"]},
        {"name": "never_here", "unit": "1", "better": "higher", "source": "host_clock",
         "layer": "train step", "moves": "train_step_ms", "workloads": ["tiny-new.new-mix"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = harness.load_benchmark(tmp_path)
    cell, cfg, traffic = harness.load_cell(bench, "tiny-new.new-mix", tmp_path)
    assert cfg == {"plm": {"n_layers": 1}} and traffic["batch"] == 3
    assert harness.load_runner(traffic["runner"]).run is not None
    names = [m["name"] for m in harness.metrics_of(bench, "per_layer", "tiny-new.new-mix")]
    assert "new_metric.x" in names and "mfu.synth" not in names
    got = harness.read_metrics(bench, "per_layer", "tiny-new.new-mix", {"steps": 21}, tmp_path)
    assert got["new_metric.x"] == {"value": 42.0, "unit": "1"}
    assert "never_here" not in got  # a reader that finds nothing leaves the metric out
    for p, data in before.items():
        assert p.read_bytes() == data


def test_every_declared_metric_has_a_reader_and_every_cell_its_files():
    bench = harness.load_benchmark()
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert harness.reader_path(m["name"]).is_file(), m["name"]
    for cell in bench["workloads"]:
        _, cfg, traffic = harness.load_cell(bench, cell["name"])
        assert harness.load_limits(cell["name"])
        assert (ROOT / "benchmark/runners" / f"{traffic['runner']}.py").is_file()
        kinds = {m["moves"] for m in harness.metrics_of(bench, "per_layer", cell["name"])}
        e2e = {m["name"] for m in harness.metrics_of(bench, "end_to_end", cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2 and kinds and kinds <= e2e
