"""The port's serving replicas on the card, in both layouts the CLI places
them in (replica i on ``cuda:(i % device_count)``): two replicas sharing
``cuda:0``, and replica 0 on ``cuda:0`` beside replica 1 on ``cuda:1``.

Every ladder is captured from the main thread, whose current device stays
``cuda:0``, as ``EngineReplica.startup`` is called by the CLI and the
smoke; then both schedulers' workers serve at once.  Each answer, from a
direct dispatch and from the worker threads, is held within rtol/atol 1e-4
against the eager forward of the same seed-0 VGG-11 on the replica's own
card, on inputs made from a seed, distinct for every request, so that a
graph captured onto another card's stream (empty, or replaying stale
outputs) cannot pass.  Then a weight watcher installs a published
version into both replicas while their workers run: it stages each
replica's state on that replica's card (``install_weights`` refuses a
state staged elsewhere), and each answers as the eager forward of the
published weights on its own card, from the same graphs.  Needs the
card: marked ``gpu`` and skipped without one, the two-card case without
two cards.  It imports nothing of the JAX package, so it runs where JAX
is absent.
"""

import numpy as np
import pytest
import torch

from cs744_ddp_tpu_torch.models import get_model
from cs744_ddp_tpu_torch.models.serving import make_u8_forward
from cs744_ddp_tpu_torch.publish import WeightPublisher, WeightWatcher
from cs744_ddp_tpu_torch.serve import EngineReplica

BUCKETS = (1, 8, 32)
RTOL = 1e-4
LAYOUTS = {"one card": (0, 0), "two cards": (0, 1)}
SIZES = (1, 3, 8, 20, 32, 5)


def _eager(device, seed=0):
    """The plain forward of the replicas' model on ``device``."""
    net = get_model("vgg11", seed).to(device,
                                      memory_format=torch.channels_last)
    forward = make_u8_forward(net.eval())

    def run(images):
        x = torch.from_numpy(images).to(device)
        labels = torch.full((len(images),), -1, dtype=torch.int64,
                            device=device)
        return forward(x, labels)[0].cpu().numpy()
    return run


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_replicas_serve_from_their_own_card(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ladder is CUDA graphs)")
    cards = LAYOUTS[layout]
    if torch.cuda.device_count() <= max(cards):
        pytest.skip(f"{layout}: needs {max(cards) + 1} CUDA devices")
    torch.cuda.set_device(0)
    devices = [torch.device("cuda", c) for c in cards]
    replicas = [EngineReplica(i, "vgg11", device=d, buckets=BUCKETS, seed=0,
                              shed=False)
                for i, d in enumerate(devices)]
    for rep in replicas:
        report = rep.startup()
        assert report["backend"] == "cuda"
        assert torch.cuda.current_device() == 0
    eager = {d: _eager(d) for d in set(devices)}
    rng = np.random.default_rng(4)

    def images(n):
        return rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)

    for rep in replicas:
        for n in SIZES:
            x = images(n)
            got = rep.engine.infer_counts(x)[0]
            np.testing.assert_allclose(got, eager[rep.engine.device](x),
                                       rtol=RTOL, atol=RTOL)
    # Both workers at once, each replaying on its own card.
    sent = []
    for rep in replicas:
        rep.start()
    try:
        for _ in range(3):
            for rep in replicas:
                for n in SIZES:
                    x = images(n)
                    sent.append((rep, x, rep.scheduler.submit(x)))
        replies = [(rep, x, fut.result(120)) for rep, x, fut in sent]
    finally:
        for rep in replicas:
            rep.stop()
    for rep, x, reply in replies:
        assert reply.status in ("ok", "late") and reply.replica == rep.index
        np.testing.assert_allclose(reply.logits, eager[rep.engine.device](x),
                                   rtol=RTOL, atol=RTOL)
    assert all(slot.handle is None for rep in replicas
               for slot in rep.engine._slots)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_watcher_stages_on_each_replicas_card(layout, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ladder is CUDA graphs)")
    cards = LAYOUTS[layout]
    if torch.cuda.device_count() <= max(cards):
        pytest.skip(f"{layout}: needs {max(cards) + 1} CUDA devices")
    torch.cuda.set_device(0)
    devices = [torch.device("cuda", c) for c in cards]
    replicas = [EngineReplica(i, "vgg11", device=d, buckets=BUCKETS, seed=0,
                              shed=False)
                for i, d in enumerate(devices)]
    for rep in replicas:
        rep.startup()
    graphs = [dict(rep.engine._rungs) for rep in replicas]
    WeightPublisher(str(tmp_path), fingerprint={"model": "vgg11"}).publish(
        get_model("vgg11", 1).state_dict())
    watcher = WeightWatcher(str(tmp_path), replicas)
    rng = np.random.default_rng(5)
    for rep in replicas:
        rep.start()
    try:
        assert watcher.poll_once() == "installed"
        sent = []
        for rep in replicas:
            for n in SIZES:
                x = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
                sent.append((rep, x, rep.scheduler.submit(x)))
        replies = [(rep, x, fut.result(120)) for rep, x, fut in sent]
    finally:
        for rep in replicas:
            rep.stop()
    assert torch.cuda.current_device() == 0
    eager = {d: _eager(d, seed=1) for d in set(devices)}
    for rep, x, reply in replies:
        assert reply.status in ("ok", "late") and reply.model_version == 1
        np.testing.assert_allclose(reply.logits, eager[rep.engine.device](x),
                                   rtol=RTOL, atol=RTOL)
    assert [dict(rep.engine._rungs) for rep in replicas] == graphs
