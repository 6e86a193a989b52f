"""The harness finds every piece of a cell by name, from BENCHMARK.json
alone, and a cell, a mix or a metric is added by files and entries."""
import json
import shutil
from pathlib import Path

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]


def _bench():
    return spec.load(ROOT / "BENCHMARK.json")


def test_every_cell_config_traffic_limit_and_reader_is_found():
    bench = _bench()
    names = {m["name"] for m in bench["per_layer"]}
    for w in bench["workloads"]:
        cell = spec.find_cell(bench, w["name"], ROOT / "benchmark")
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] in ("serve_stream", "train_steps")
        assert hasattr(cell.driver(), "measure")
        assert cell.limits, f"{w['name']} has no limits file"
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    assert names == {p.name[:-3] for p in
                     (ROOT / "benchmark" / "metrics").glob("*.py")}


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _bench()
    (tmp_path / "benchmark" / "traffic" / "serve-tiny.json").write_text(
        json.dumps({"kind": "serve_stream", "height": 64, "width": 96}))
    (tmp_path / "benchmark" / "metrics" / "throwaway_ms.serve.py").write_text(
        "def read(m):\n    return 1.5\n")
    (tmp_path / "benchmark" / "limits" / "rb53-f32.serve-tiny.json"
     ).write_text(json.dumps({"final_rel_rms": {"limit": 1.0}}))
    bench["workloads"].append({"name": "rb53-f32.serve-tiny",
                               "config": "rb53-f32", "traffic": "serve-tiny",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "throwaway_ms.serve", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine (infer/engine.py)",
                               "moves": "interp_fps"})
    for m in bench["end_to_end"]:
        if m["name"] == "interp_fps":
            m["workloads"].append("rb53-f32.serve-tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    found = spec.find_cell(spec.load(tmp_path / "BENCHMARK.json"),
                           "rb53-f32.serve-tiny", tmp_path / "benchmark")
    assert found.traffic["height"] == 64
    assert found.limits == {"final_rel_rms": {"limit": 1.0}}
    assert "throwaway_ms.serve" in [m["name"] for m in found.per_layer]
    assert found.reader("throwaway_ms.serve")(None) == 1.5
    assert found.driver().__file__.startswith(str(tmp_path))


def test_a_new_configuration_needs_only_new_files(tmp_path):
    """A configuration of other widths and no boosting (DeMFI-Net_bs at a
    tiny size): its file alone sizes the reference, the weights, the
    FLOP count and the program, and a run on the CPU comes out correct."""
    import time

    import torch

    from benchmark import reference
    from benchmark.counts import flops
    from benchmark.harness import Run, verdict

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(ROOT / "benchmark" / "configs" / "rb53-f32.json") as f:
        rb = json.load(f)
    bs = json.loads(json.dumps(rb))
    bs.update(name="bs-tiny", N_trn=0, N_tst=0)
    for block in (bs["architecture"], bs["program"]["fields"]):
        block.update(nf=32, num_ResB_FACFB=2, num_ResB_Dec=2)
    (tmp_path / "benchmark" / "configs" / "bs-tiny.json").write_text(
        json.dumps(bs))
    (tmp_path / "benchmark" / "limits" / "bs-tiny.serve-sd.json"
     ).write_text(json.dumps({"final_rel_rms": {"limit": 1e-4}}))
    bench = _bench()
    bench["configs"].append(dict(bench["configs"][1], name="bs-tiny",
                                 file="benchmark/configs/bs-tiny.json"))
    bench["workloads"].append({"name": "bs-tiny.serve-sd",
                               "config": "bs-tiny", "traffic": "serve-sd",
                               "chips": 1, "why": "a throwaway cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell(spec.load(tmp_path / "BENCHMARK.json"),
                          "bs-tiny.serve-sd", tmp_path / "benchmark")

    shapes = dict(reference.param_shapes(cell.config))
    assert shapes["FAC_FB_Module.conv_first.weight"] == (32, 32, 3, 3)
    assert "Booster_Module.GB.convz1.weight" not in shapes
    assert "FAC_FB_Module.feature_extraction.2.conv1.weight" not in shapes
    assert flops.serve_window(cell.config, 64, 96, 7, 0) < \
        flops.serve_window(rb, 64, 96, 7, 3)
    wide = json.loads(json.dumps(rb))
    wide["architecture"].update(G0=64, growth=16)
    assert dict(reference.param_shapes(wide))[
        "FF_RDB_Module.RDBs.0.convs.1.conv.0.weight"] == (16, 80, 3, 3)

    cell.traffic.update(height=40, width=72, clip_windows=4,
                        warmup_windows=1, check_windows=2)
    run = Run(cell=cell, seed=2 ** 31 + 29, seconds=0.5, traced=False,
              device=torch.device("cpu"), started=time.perf_counter())
    m = cell.driver().measure(run)
    assert verdict(m.numbers, cell.limits)[0], m.numbers
