"""The readers of the program's own spans (metrics/device_scene_s.py).

A reader returns None where the program records no such span (the module
not loaded, a program without the recorder, no scene built yet) and the
hand-worked value on a synthetic recorder; after a real scene build on the
CPU it reads that build's span.
"""

import sys
import types

import harness

RECORD = {"spans": {}, "window": {}, "trace": None, "setup_s": 1.0}
NS = 1_000_000_000


def _reader(name):
    return harness.load_reader(harness.BENCH_DIR + "/metrics", name)


def test_device_scene_s_is_none_without_the_span(monkeypatch):
    read = _reader("device_scene_s")
    monkeypatch.delitem(sys.modules, "strelka_tpu_torch.utils.profiling", raising=False)
    assert read(RECORD) is None
    monkeypatch.setitem(sys.modules, "strelka_tpu_torch.utils.profiling", types.ModuleType("profiling"))
    assert read(RECORD) is None  # the program before the recorder
    recorder = types.SimpleNamespace(setup_spans=lambda: [{"name": "bvh.build", "start_ns": 0, "end_ns": NS}])
    monkeypatch.setitem(sys.modules, "strelka_tpu_torch.utils.profiling", recorder)
    assert read(RECORD) is None


def test_device_scene_s_reads_the_newest_build(monkeypatch):
    spans = [{"name": "device_scene.build", "start_ns": 5 * NS, "end_ns": 7 * NS},
             {"name": "bvh.build", "start_ns": 20 * NS, "end_ns": 21 * NS},
             {"name": "device_scene.build", "start_ns": 20 * NS, "end_ns": 23 * NS + NS // 4},
             {"name": "launch.eager", "start_ns": 24 * NS, "end_ns": 30 * NS}]
    recorder = types.SimpleNamespace(setup_spans=lambda: spans)
    monkeypatch.setitem(sys.modules, "strelka_tpu_torch.utils.profiling", recorder)
    assert _reader("device_scene_s")(RECORD) == 3.25


def test_device_scene_s_after_a_cpu_build():
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.utils import profiling as P

    P.reset()
    build_device_scene(TS.cornell_box(), device="cpu")
    span = [s for s in P.setup_spans() if s["name"] == "device_scene.build"][-1]
    assert _reader("device_scene_s")(RECORD) == (span["end_ns"] - span["start_ns"]) / 1e9 > 0
