"""The port's epoch streaming (`yolo_from_scratch_tpu_torch/data/
stream.py`), its pool trainer (`make_train_step_multi_pool`) and the CLI's
`--stream` against the JAX package's, on the CPU at 64x64, width 0.25,
nc=3, batch 2, float32.

- `_epoch_chunks` and ChunkStream's chunks are bit-equal to JAX's for a
  seed; PoolStream's index draws and slot writes are equal to JAX's.
- The ingest cap's schedule is checked against an injected clock: no slab
  is staged before the capped schedule says it is due, and the next one
  comes once the clock reaches it (no wall-clock bound that a slow host
  could break).
- The pool trainer against JAX's, mosaic and augmentation off, at
  tests/test_torch_multistep.py's tolerances; against the port's compact
  trainer on the gathered batches, mosaic and augmentation on, bit-equal.
- `--stream` and `--stream --stream-pool 4` train two epochs through the
  CLI; the checkpoint's step is the number of steps taken and JAX's
  `restore_train_state` reads it; the guards exit 1 with JAX's messages.
"""

import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_multistep import (
    B,
    IMG,
    N,
    _cfg,
    assert_same_state,
    hold_to_jax,
    jax_state,
    make_chunk,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    port_state,
    variables,
)

from yolo_from_scratch_tpu.data import stream as jstream
from yolo_from_scratch_tpu.data.cache import build_cache as jax_build_cache
from yolo_from_scratch_tpu.data.dataset import YoloDataset as JaxDataset
from yolo_from_scratch_tpu.models.yolo import YOLO as JaxYOLO
from yolo_from_scratch_tpu.train.loop import restore_train_state
from yolo_from_scratch_tpu.train.steps import make_optimizer as jax_optimizer
from yolo_from_scratch_tpu.train.steps import (
    make_train_step_multi_pool as jax_multi_pool,
)
from yolo_from_scratch_tpu_torch import cli
from yolo_from_scratch_tpu_torch.data import stream as tstream
from yolo_from_scratch_tpu_torch.data.cache import build_cache
from yolo_from_scratch_tpu_torch.data.dataset import YoloDataset
from yolo_from_scratch_tpu_torch.train.steps import (
    make_train_step_multi_compact,
    make_train_step_multi_pool,
)

K = 8


@pytest.fixture(scope="module")
def caches(temp_dataset_dir, tmp_path_factory):
    """The 5-image nc=1 split cached by each package (byte-equal files,
    tests/test_torch_cache.py)."""
    images = str(temp_dataset_dir / "train" / "images")
    root = tmp_path_factory.mktemp("stream_caches")
    port = build_cache(YoloDataset(images, 1, img_size=IMG, backend="pil"),
                       str(root / "port"), capacity=K, log=None)
    jax_cache = jax_build_cache(
        JaxDataset(images, 1, img_size=IMG, backend="pil"),
        str(root / "jax"), capacity=K, log=None)
    return port, jax_cache


@pytest.mark.parametrize("n,chunk,shuffle", [(12, 4, True), (10, 4, True),
                                             (10, 4, False), (5, 8, True)])
def test_epoch_chunks_equal_jax(n, chunk, shuffle):
    rngs = [np.random.default_rng(3), np.random.default_rng(3)]
    for _ in range(2):  # two epochs from one generator
        got = tstream._epoch_chunks(n, chunk, shuffle, rngs[0])
        want = jstream._epoch_chunks(n, chunk, shuffle, rngs[1])
        assert len(got) == len(want) == -(-n // chunk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert set(np.concatenate(got)) == set(range(n))


def test_chunk_stream_equals_jax(caches):
    """Two epochs of chunks, shuffled from one seed, wrap-padded (5 images
    in chunks of 2 steps x 2)."""
    port, jax_cache = caches
    ours = tstream.ChunkStream(port, batch_size=B, steps_per_chunk=2,
                               seed=4, device="cpu")
    theirs = jstream.ChunkStream(jax_cache, batch_size=B, steps_per_chunk=2,
                                 seed=4)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 4
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert [t.shape for t in g] == [(2, B, IMG, IMG, 3),
                                            (2, B, K, 5), (2, B)]
            for gt, wt in zip(g, w):
                np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def test_chunk_stream_surfaces_io_errors(caches):
    port, _ = caches

    class Broken(tstream.ChunkStream):
        def _gather(self, stager, idx):
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(Broken(port, batch_size=B, steps_per_chunk=2, device="cpu"))


class _Recorder:
    """A trainer stand-in that records the index draws."""

    def __init__(self, metric):
        self.idx, self.metric = [], metric

    def __call__(self, state, images, labels, counts, idx):
        self.idx.append(np.asarray(idx))
        return state, {"loss": self.metric(0.5)}


def test_pool_index_draws_and_slot_writes_equal_jax(caches):
    port, jax_cache = caches
    kw = dict(pool_size=4, batch_size=B, steps_per_chunk=2, refresh_slab=2,
              seed=6)
    ours = tstream.PoolStream(port, device="cpu", **kw)
    theirs = jstream.PoolStream(jax_cache, **kw)
    for o, t in zip(ours.pool, theirs.pool):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    # ingest two slabs by hand: rows 4, 0 into slots 0, 1; rows 1, 2 into 2, 3
    for _ in range(2):
        ours._apply_slab(*ours._stage_slab())
        theirs._apply_slab(*theirs._stage_slab())
    for o, t in zip(ours.pool, theirs.pool):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    np.testing.assert_array_equal(ours.pool[0][0].numpy(), port.images[4])
    np.testing.assert_array_equal(ours.pool[0][3].numpy(), port.images[2])
    # the epochs' index draws (the refreshers stopped: no slab lands)
    rec_o, rec_t = _Recorder(torch.tensor), _Recorder(np.float32)
    for _ in range(2):
        ours._ensure_refresher = theirs._ensure_refresher = lambda: None
        _, means, n, _ = ours.run_epoch(rec_o, None)
        theirs.run_epoch(rec_t, None)
        assert n == 8 and means["loss"] == 0.5 and "ingest_img_s" in means
    assert len(rec_o.idx) == len(rec_t.idx) == 4
    for g, w in zip(rec_o.idx, rec_t.idx):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


class _Clock:
    """A clock the test moves."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_ingest_cap_follows_its_schedule(caches):
    """2-image slabs at a 4 img/s cap: slab k is due at k * 0.5 s of the
    injected clock. With the clock held, only slab 0 is staged; moving it
    to 0.5 s lets slab 1 through, and no further."""
    port, _ = caches
    clock = _Clock()
    pool = tstream.PoolStream(port, pool_size=4, batch_size=1,
                              steps_per_chunk=2, refresh_slab=2, seed=0,
                              device="cpu", max_ingest_img_s=4.0, clock=clock)
    pool._ensure_refresher()
    try:
        first = pool._slab_q.get(timeout=30)
        time.sleep(0.5)  # the refresher polls every 0.1 s
        assert pool._slab_q.empty(), "slab 1 staged before it was due"
        clock.now = 0.5
        second = pool._slab_q.get(timeout=30)
        time.sleep(0.3)
        assert pool._slab_q.empty(), "slab 2 staged before it was due"
        assert (first[2], second[2]) == (0, 2)  # their pool slots
    finally:
        pool.stop()
    assert pool._thread is None


def test_stop_and_restart_share_the_cursor(caches):
    """stop() ends the refresher; the next epoch's refresher goes on from
    the same cursor and slot."""
    port, _ = caches
    pool = tstream.PoolStream(port, pool_size=4, batch_size=1,
                              steps_per_chunk=2, refresh_slab=2, seed=0,
                              device="cpu")
    pool._ensure_refresher()
    pool._slab_q.get(timeout=30)
    pool.stop()
    assert pool._thread is None
    cursor, slot = pool._cursor, pool._slot
    pool._ensure_refresher()
    try:
        staged = pool._slab_q.get(timeout=30)
        assert staged[2] in (slot, (slot + 2) % 4)
        assert pool._cursor != cursor or len(port) <= 2
    finally:
        pool.stop()


def _pool_inputs(seed=0, repeats=True):
    """A pool of the N x B distinct images of `make_chunk` and (N, B) int32
    draws into it; `repeats=False` draws no image twice in a batch."""
    images, labels, counts = make_chunk(seed=seed)
    pool = tuple(a.reshape(N * B, *a.shape[2:])
                 for a in (images, labels, counts))
    rng = np.random.default_rng(seed)
    if repeats:
        idx = rng.integers(0, N * B, (N, B), np.int32)
    else:
        idx = np.stack([rng.permutation(N * B)[:B] for _ in range(N)])
    return pool, idx.astype(np.int32)


@pytest.fixture(scope="module")
def jax_pool_trainer():
    """JAX's pool trainer (anchor head, Adam), compiled once."""
    cfg = _cfg()
    tx, _ = jax_state(variables(cfg))
    return jax_multi_pool(JaxYOLO(cfg), tx, cfg, donate=False)


def _pool_held_to_jax(jax_pool_trainer, pool, idx):
    cfg = _cfg()
    var = variables(cfg)
    _, st0 = jax_state(var)
    jax_out = jax_pool_trainer(st0, *(jnp.asarray(a) for a in pool),
                               jnp.asarray(idx))
    state = port_state(cfg, var)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    state, metrics = make_train_step_multi_pool(cfg)(
        state, *(torch.from_numpy(a) for a in pool), torch.from_numpy(idx))
    hold_to_jax(state, start, jax_out, metrics)


def test_pool_trainer_matches_jax(jax_pool_trainer):
    # no image twice in a batch: with two copies of one image the SPPF
    # conv's weight gradient vanishes at this size (the test below), and
    # Adam's scale-free first step turns the rounding noise left into
    # changes of up to lr
    _pool_held_to_jax(jax_pool_trainer, *_pool_inputs(repeats=False))


def test_pool_trainer_with_repeats_matches_jax(jax_pool_trainer):
    """Draws with repeats, the last step's batch two copies of one image:
    the whole state is held to JAX. (A repeated batch at the first step is
    not: there Adam's first update turns the vanished gradient's rounding
    noise into steps of +-lr that each package takes its own way.)"""
    pool, idx = _pool_inputs(seed=1, repeats=True)
    assert idx[-1, 0] == idx[-1, 1] and len(set(idx[0])) == B
    _pool_held_to_jax(jax_pool_trainer, pool, idx)


def _sppf_conv2_grads(img, n_pooled):
    """Both packages' gradients of SPPF's output conv on a batch of two
    copies of one image at img x img: (port, JAX) weight gradients split
    into the 1 + n_pooled input blocks [x, y1, y2, y3] (each block's
    largest magnitude)."""
    from yolo_from_scratch_tpu.config import YoloConfig
    from yolo_from_scratch_tpu.train.steps import _make_expand as jax_expand
    from yolo_from_scratch_tpu.train.steps import _make_loss_fn
    from yolo_from_scratch_tpu_torch.train.steps import (
        _make_expand,
        make_loss_fn,
    )

    cfg = YoloConfig(num_classes=3, img_size=img, width_mult=0.25,
                     depth_mult=0.33)
    var = variables(cfg)
    rng = np.random.default_rng(img)
    image = rng.integers(0, 256, (1, img, img, 3), dtype=np.uint8)
    boxes = [np.asarray([[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.2]],
                        np.float32)]
    from yolo_from_scratch_tpu_torch.data.assign_device import pack_labels

    labels, counts = pack_labels(boxes * 2, [np.asarray([0, 2])] * 2, K)
    images = np.concatenate([image, image])
    state = port_state(cfg, var)
    x, t = _make_expand(cfg, True)(0, torch.from_numpy(images), (
        torch.from_numpy(labels), torch.from_numpy(counts)))
    make_loss_fn(cfg)(state.model, x, t)[0].backward()
    port = state.model.sppf.conv2.conv.weight.grad[:, :, 0, 0].T.numpy()
    xi, ti = jax_expand(cfg, True)(0, jnp.asarray(images), (
        jnp.asarray(labels), jnp.asarray(counts)))
    import jax

    loss_fn = _make_loss_fn(JaxYOLO(cfg), cfg, False)
    grads = jax.jit(jax.grad(
        lambda p: loss_fn(p, var["batch_stats"], xi, ti)[0]))(var["params"])
    jax_g = np.asarray(grads["sppf"]["conv2"]["conv"]["kernel"])[0, 0]
    hidden = port.shape[0] // 4
    return [[np.abs(g[i * hidden:(i + 1) * hidden]).max() for i in range(4)]
            for g in (port, jax_g)]


@pytest.mark.parametrize("img,vanished", [(64, (1, 2, 3)), (128, (2, 3))])
def test_sppf_gradient_vanishes_on_a_repeated_batch(img, vanished):
    """The pool trainer's fault with repeats, pinned: SPPF's output conv
    sees [x, y1, y2, y3], y_k the k-fold 5x5 max pool (a 5, 9, 13 px
    window). Where the window covers the whole P5 map (2x2 at 64, 4x4 at
    128 for y2 and y3), y_k is constant over the map; with two copies of
    one image in the batch the train-mode BatchNorm after the conv takes
    out the batch's mean, and the weight gradient of those input blocks
    is rounding noise in both packages (under 1e-5 of the x block's),
    while the others are not."""
    for blocks in _sppf_conv2_grads(img, 3):
        for i in range(1, 4):
            ratio = blocks[i] / blocks[0]
            if i in vanished:
                assert ratio < 1e-5, (img, i, ratio)
            else:
                assert ratio > 1e-2, (img, i, ratio)


@pytest.mark.parametrize("head", ["anchor", "anchor_free"])
def test_pool_trainer_equals_compact_trainer_on_gathered_batches(head):
    cfg = _cfg(head)
    var = variables(cfg, seed=7)
    pool, idx = _pool_inputs(seed=1)
    flags = dict(device_mosaic=True, device_augment=True, augment_seed=3,
                 sparse_loss=head == "anchor")
    pool_t = [torch.from_numpy(a) for a in pool]
    a, ma = make_train_step_multi_pool(cfg, **flags)(
        port_state(cfg, var), *pool_t, torch.from_numpy(idx))
    ix = torch.from_numpy(idx).long()
    b, mb = make_train_step_multi_compact(cfg, **flags)(
        port_state(cfg, var), *(t[ix] for t in pool_t))
    assert_same_state(a, b)
    for k in ma:
        torch.testing.assert_close(ma[k], mb[k], rtol=0, atol=0)


def test_pool_stream_epoch_trains(caches):
    port, _ = caches
    cfg = _cfg().with_(num_classes=1)
    state = port_state(cfg, variables(cfg, seed=2))
    pool = tstream.PoolStream(port, pool_size=4, batch_size=B,
                              steps_per_chunk=2, refresh_slab=2, seed=0,
                              device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    try:
        state, means, n, dt = pool.run_epoch(
            make_train_step_multi_pool(cfg), state)
    finally:
        pool.stop()
    assert state.step == pool.steps_per_epoch == 4 and n == 8 and dt > 0
    assert np.isfinite(means["loss"]) and means["ingest_img_s"] >= 0
    assert any(not torch.equal(p, q) for p, q in
               zip(before, state.model.parameters()))


EPOCH = re.compile(r"Epoch (\d): Loss: \d+\.\d{4} .* \| LR: \S+ \| "
                   r"\S+ img/s( \| ingest \S+ img/s)?$", re.M)


def _run(capsys, argv):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--stream-pool", "4"]])
def test_cli_stream_trains_and_jax_restores(temp_dataset_multiclass,
                                            tmp_path, monkeypatch, capsys,
                                            extra):
    """Two epochs of 4 images at batch 2 in chunks of 2 steps: 2 steps an
    epoch, the checkpoint's step 4; the cache lands in --cache-dir."""
    monkeypatch.chdir(tmp_path)
    yaml_file = str(temp_dataset_multiclass / "dataset.yaml")
    rc, out = _run(capsys, [
        yaml_file, "--epochs", "2", "--batch-size", "2", "--size", "n",
        "--img-size", str(IMG), "--device", "cpu", "--lr", "1e-3",
        "--stream", "--stream-chunk", "2", "--compact-targets", "8",
        "--device-mosaic", "--device-augment", "--sparse-loss",
        "--cache-dir", str(tmp_path / "cache"), *extra])
    assert rc == 0, out
    epochs = EPOCH.findall(out)
    assert [e[0] for e in epochs] == ["1", "2"], out
    assert all(bool(e[1]) == bool(extra) for e in epochs), out
    assert ("via a 4-image HBM pool, 2 steps/dispatch" in out) == bool(extra)
    assert (tmp_path / "cache" / "meta.json").exists()
    ckpt = re.search(r"Model saved to (\S+)", out).group(1)
    jax_st, _, start_epoch, _ = restore_train_state(ckpt, jax_optimizer(1e-3))
    assert start_epoch == 2 and int(jax_st.step) == 4
    assert int(jax_st.opt_state.count) == 4
    assert int(jax_st.opt_state.inner_state[1][0].count) == 4


@pytest.mark.parametrize("argv,words,rc", [
    (["--stream-pool", "4"], "--stream-pool/--cache-dir require --stream", 1),
    (["--cache-dir", "c"], "--stream-pool/--cache-dir require --stream", 1),
    (["--stream", "--ema"], "--stream does not compose with --ema", 1),
    (["--stream", "--augment"], "--stream does not compose with --augment",
     1),
    (["--stream", "--device-mosaic"], "--device-mosaic requires "
                                      "--compact-targets", 1),
])
def test_cli_stream_guards(temp_dataset_multiclass, capsys, argv, words, rc):
    yaml_file = str(temp_dataset_multiclass / "dataset.yaml")
    got, out = _run(capsys, [yaml_file, "--device", "cpu", *argv])
    assert got == rc and f"ERROR: {words}" in out, out
