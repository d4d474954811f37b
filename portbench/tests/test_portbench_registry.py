"""The harness finds configurations, traffic, limits, metrics and drivers by
name, and a new file of each kind joins without an edit to an existing one."""
import json

from portbench.core import Bench
from portbench.tests import tiny


def test_names_in_the_package():
    bench = Bench()
    assert "frostnet_quant_large_1_0" in bench.names("configs")
    assert {"imagenet_qat_b256", "cls_int8_b128", "cityscapes_int8_b8_512x1024",
            "cityscapes_qat_b16_768"} <= set(bench.names("traffic"))
    for w in bench.spec["workloads"]:
        assert w["name"] in bench.names("limits")
        cell_cfg, cell_tr = bench.config(w["config"]), bench.traffic(w["traffic"])
        assert bench.driver(cell_tr, cell_cfg).run
        assert bench.reference(cell_cfg).Reference
    metrics = set(bench.names("metrics"))
    assert {m["name"] for m in bench.spec["per_layer"]} == metrics
    for name in metrics:
        assert callable(bench.metric_reader(name))


def test_a_new_cell_joins_without_edits(tmp_path):
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = tiny.tiny_config()
    cfg["name"] = "tiny_wide"
    cfg["arch"]["width_mult"] = 0.5
    cfg["model"] = "frostnet_quant_small_0_5"
    from portbench.costs import conv_flops
    from portbench.reference import frostnet
    tables = frostnet.shape_tables(cfg["arch"], 32)
    cfg["tables"] = {"32x32": tables}
    cfg["forward_flops"] = {"32x32": conv_flops(tables["convs"])}
    (root / "configs" / "tiny_wide.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "traffic" / "tiny_cls_int8_b128.json").read_text())
    tr.update(batch=2, pool=2)
    (root / "traffic" / "tiny_pairs.json").write_text(json.dumps(tr))
    (root / "limits" / "tiny-wide-serve.json").write_text(json.dumps({"limits": {"logit_gap": 0.05}}))
    (root / "metrics" / "requests.serve.py").write_text(
        "def read(m):\n    return float(m.units_outside) if m.units_outside else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-wide-serve", "config": "tiny_wide",
                              "traffic": "tiny_pairs", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "requests.serve", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "serve_images_per_s", "workloads": ["tiny-wide-serve"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "frostnet-int8-serve" in m["workloads"]:
            m["workloads"].append("tiny-wide-serve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(root)
    assert "tiny_wide" in bench.names("configs") and "requests.serve" in bench.names("metrics")
    line = tiny.run(root, "tiny-wide-serve", trace=True)
    assert line["correct"] is True
    assert line["metrics"]["requests.serve"]["value"] > 0
    assert {p: p.read_bytes() for p in before} == before
