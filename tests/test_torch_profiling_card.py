"""The span-and-counter recorder (utils/profiling.py) on the card.

TorchRender's replayed frames of Cornell at 512x512, 1 spp, depth 4:
(a) with the recorder off the key's graph has the node count recorded for
    it (NODES_OFF: each bounce's surface phase less its texture lookups one
    K13 node, its BSDF phase one K10 node, its NEE phase a K11 and a K12 node
    around the shadow sweep). Off, the recorder
    adds no node to a graph;
(b) with it on, a replayed frame's top-level device spans sum to within 2%
    of the frame's device time by CUDA events (from a mark right before the
    graph replay to an event behind render(), as the benchmark times a
    frame), and the graph captured with it on has more nodes (the events and
    the lane counters);
(c) the images of the frames are bit-equal with the recorder on and off.

These tests need a CUDA card and skip without one. The tests' conftest.py
imports jax, which the card's machine lacks; run them there with

    python -m pytest --noconftest -m card tests/test_torch_profiling_card.py
"""

import numpy as np
import pytest
import torch

from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.render import GraphLaunch, TorchRender
from strelka_tpu_torch.scene import testscenes as TS
from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils import profiling as P

# a frame long enough that its work, not the graph's per-node latency, sets it (as on the benchmark's cells):
# the ~0.04 ms from the mark before the replay to the graph's first node is outside every span
SIZE = 512
FRAMES = 5  # the key's eager launch, its capture and replay, three replays
NODES_OFF = 789  # cuGraphGetNodes of the key's graph, recorder off (NVIDIA H100 80GB HBM3, torch 2.11)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(device, on: bool):
    """FRAMES frames from the same start: (images, each frame's (event ms,
    top-level span ms) with the recorder on, the key's GraphLaunch)."""
    P.reset()
    (P.enable if on else P.disable)()
    s = make_default_settings(SIZE, SIZE)
    s.set("render/pt/spp", 1)
    s.set("render/pt/depth", 4)
    s.set("render/pt/sppTotal", 64)
    r = TorchRender(device=device)
    r.set_scene(TS.cornell_box())
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(SIZE, SIZE, BufferFormat.FLOAT4))
    images, timed = [], []
    replay = torch.cuda.CUDAGraph.replay
    marks = []

    def marked(self, *a, **k):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return replay(self, *a, **k)

    torch.cuda.CUDAGraph.replay = marked
    try:
        for i in range(FRAMES):
            r.render(buf)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            images.append(buf.map().copy())
            rows = P.collect()["device"]
            if on and i >= 2:  # replayed frames
                timed.append((marks[-1].elapsed_time(end), sum(x["ms"] for x in rows if x["parent"] is None)))
    finally:
        torch.cuda.CUDAGraph.replay = replay
        P.disable()
    graph = next(fn for fn in r._launch_cache.values() if isinstance(fn, GraphLaunch))
    return images, timed, graph


@pytest.mark.card
def test_recorder_on_the_card(card):
    off_images, _, off_graph = _frames(card, False)
    assert off_graph.nodes() == NODES_OFF
    on_images, timed, on_graph = _frames(card, True)
    assert on_graph.nodes() > NODES_OFF
    assert len(timed) == FRAMES - 2
    for event_ms, top_ms in timed:
        assert abs(top_ms - event_ms) <= 0.02 * event_ms, timed
    assert all(np.array_equal(a, b) for a, b in zip(off_images, on_images))
    P.reset()
