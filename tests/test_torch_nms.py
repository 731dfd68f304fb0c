"""NMS of the PyTorch port against the JAX package, on the CPU.

The port's plain versions (`yolo_from_scratch_tpu_torch/ops/nms.py`) are
the oracles of its CUDA kernel; here they are held against the JAX lax
oracle and the Pallas kernel in interpret mode, on the same numpy inputs.
Keep masks and NMS outputs must be BIT-EQUAL (no tolerance): both sides
compute each IoU with unfused float32 ops in the same order. A mismatch
can only come from an IoU within one ulp of the threshold (jitted XLA on
the CPU may round an IoU an ulp differently), and the assertion message
says so rather than the test loosening.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_from_scratch_tpu.ops import nms as jnms
from yolo_from_scratch_tpu.ops.nms_pallas import (
    batched_nms_fixed_pallas,
    batched_nms_fixed_pallas_images,
    nms_keep_mask_pallas,
    nms_keep_mask_pallas_batched,
)
from yolo_from_scratch_tpu_torch.ops import nms as tnms
from yolo_from_scratch_tpu_torch.ops import nms_cuda
from yolo_from_scratch_tpu_torch.ops.boxes import box_iou_corner

ULP_NOTE = ("keep masks differ: check for an IoU within one float32 ulp of "
            "the threshold before suspecting the port")


def _random_boxes(seed, n, spread=60):
    """The box generator of tests/test_nms_pallas.py."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    return boxes, scores


def _tied(seed, n):
    """Clustered boxes whose scores take only 5 values: many exact ties."""
    boxes, _ = _random_boxes(seed, n, spread=30)
    rng = np.random.default_rng(seed + 100)
    scores = rng.choice(np.float32([0.9, 0.7, 0.5, 0.3, 0.1]), n)
    return boxes, scores.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_keep(boxes, scores, thr, max_keep=None):
    return np.asarray(jnms.nms_keep_mask(jnp.asarray(boxes),
                                         jnp.asarray(scores), thr,
                                         max_keep=max_keep))


@pytest.mark.parametrize("make", [_random_boxes, _tied])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [17, 128, 300])
def test_keep_mask_matches_jax_oracle_and_pallas(make, seed, n):
    boxes, scores = make(seed, n)
    expected = _jax_keep(boxes, scores, 0.5)
    pallas = np.asarray(nms_keep_mask_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, interpret=True))
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, expected, err_msg=ULP_NOTE)
    np.testing.assert_array_equal(got, pallas, err_msg=ULP_NOTE)


def test_padding_rows_never_kept():
    boxes, scores = _random_boxes(0, 32)
    scores[10:] = tnms.NEG_INF
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5).numpy()
    assert not got[10:].any()
    np.testing.assert_array_equal(got, _jax_keep(boxes, scores, 0.5))


@pytest.mark.parametrize("max_keep", [1, 5, 16])
def test_max_keep_cap(max_keep):
    # widely separated boxes: nothing suppressed, the cap must truncate
    boxes = np.zeros((16, 4), np.float32)
    for i in range(16):
        boxes[i] = [i * 100, 0, i * 100 + 10, 10]
    scores = np.linspace(1.0, 0.1, 16).astype(np.float32)
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5,
                             max_keep=max_keep).numpy()
    assert got.sum() == max_keep and got[:max_keep].all()
    np.testing.assert_array_equal(
        got, _jax_keep(boxes, scores, 0.5, max_keep=max_keep))


def test_max_keep_with_suppression_matches_jax():
    boxes, scores = _tied(3, 300)
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.4, max_keep=7).numpy()
    np.testing.assert_array_equal(got, _jax_keep(boxes, scores, 0.4, 7),
                                  err_msg=ULP_NOTE)


def _batch(seeds, n, make=_random_boxes):
    boxes = np.stack([make(s, n)[0] for s in seeds])
    scores = np.stack([make(s, n)[1] for s in seeds])
    return boxes, scores


@pytest.mark.parametrize("presorted", [False, True])
def test_batched_keep_mask_matches_pallas_grid(presorted):
    boxes, scores = _batch(range(5), 200)
    scores[2, 150:] = tnms.NEG_INF  # one image with padding rows
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        boxes = np.take_along_axis(boxes, order[..., None], axis=1)
        scores = np.take_along_axis(scores, order, axis=1)
    expected = np.asarray(nms_keep_mask_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, interpret=True,
        presorted=presorted))
    got = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5,
                             presorted=presorted).numpy()
    np.testing.assert_array_equal(got, expected, err_msg=ULP_NOTE)
    for i in range(len(boxes)):  # and per image against the lax oracle
        np.testing.assert_array_equal(got[i],
                                      _jax_keep(boxes[i], scores[i], 0.5))


def test_class_offset_boxes_matches_jax():
    boxes, _ = _random_boxes(5, 50)
    boxes[3, 2] = np.inf  # non-finite coordinates are ignored for the scale
    classes = np.random.default_rng(5).integers(0, 4, 50).astype(np.int32)
    expected = np.asarray(jnms._class_offset_boxes(jnp.asarray(boxes),
                                                   jnp.asarray(classes)))
    got = tnms._class_offset_boxes(_t(boxes), _t(classes)).numpy()
    np.testing.assert_array_equal(got, expected)
    # batched: one offset scale per image, as vmap gives
    bb = np.stack([boxes, boxes * 2])
    cc = np.stack([classes, classes[::-1].copy()])
    got_b = tnms._class_offset_boxes(_t(bb), _t(cc)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got_b[i], np.asarray(
            jnms._class_offset_boxes(jnp.asarray(bb[i]), jnp.asarray(cc[i]))))


@pytest.mark.parametrize("make", [_random_boxes, _tied])
@pytest.mark.parametrize("n,max_outputs,ncls", [(200, 64, 3), (160, 160, 1),
                                                 (300, 32, 4)])
def test_batched_nms_fixed_matches_jax_and_pallas(make, n, max_outputs, ncls):
    boxes, scores = make(4, n)
    scores[n - 20:] = tnms.NEG_INF
    classes = np.random.default_rng(4).integers(0, ncls, n).astype(np.int32)
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    expected = jnms.batched_nms_fixed(*args, 0.4, max_outputs=max_outputs)
    pallas = batched_nms_fixed_pallas(*args, 0.4, max_outputs=max_outputs,
                                      interpret=True)
    got = tnms.batched_nms_fixed(_t(boxes), _t(scores), _t(classes), 0.4,
                                 max_outputs)
    for g, e, p in zip(got, expected, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                      err_msg=ULP_NOTE)
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))


def test_cuda_wrapper_on_cpu_runs_plain_and_counts_nothing():
    before = nms_cuda.launches
    boxes, scores = _batch(range(10, 13), 160, _tied)
    classes = np.random.default_rng(7).integers(0, 4, (3, 160)).astype(
        np.int32)
    got = nms_cuda.batched_nms_fixed_cuda_images(
        _t(boxes), _t(scores), _t(classes), 0.4, max_outputs=32)
    expected = batched_nms_fixed_pallas_images(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.4,
        max_outputs=32, interpret=True)
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                      err_msg=ULP_NOTE)
    keep = nms_cuda.nms_keep_mask_batched(_t(boxes), _t(scores), 0.5)
    np.testing.assert_array_equal(
        keep.numpy(), tnms.nms_keep_mask(_t(boxes), _t(scores), 0.5).numpy())
    single = nms_cuda.batched_nms_fixed_cuda(
        _t(boxes[0]), _t(scores[0]), _t(classes[0]), 0.4, 32)
    for g, e in zip(single, (x[0] for x in got)):
        np.testing.assert_array_equal(g.numpy(), e.numpy())
    assert nms_cuda.launches == before


def test_cuda_wrapper_refuses_other_devices():
    boxes = torch.zeros((1, 8, 4), device="meta")
    scores = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nms_cuda.nms_keep_mask_batched(boxes, scores, 0.5)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises (it never falls back to the plain NMS)."""
    from yolo_from_scratch_tpu_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    if build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has a CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


# --- the two-pass bitmask NMS of csrc/nms.cu, modelled in plain torch ---

WORD = 64
ALL_ONES = (1 << WORD) - 1


def _tri(c, words):
    """Words of an image's workspace before chunk c (csrc/nms.cu's `tri`):
    chunk c' holds its 64 column words, then its 64 rows of words c' + 1 ..
    W - 1."""
    return WORD * (c * words - c * (c - 1) // 2)


def _bitmask_keep(boxes_s, scores_s, thr, cap):
    """A plain-torch model of the kernel's two passes on score-sorted (B, N,
    4) / (B, N) float32 tensors, with `csrc/nms.cu`'s workspace layout (per
    image and chunk of 64 ranks, the chunk's column words, then its rows
    right of the diagonal), its chunked scan, its resolve in rounds, `cap`
    and validity.

    The workspace starts with every bit set, so that a word the mask pass
    does not write (the rows of invalid ranks, their column words) and the
    scan reads anyway suppresses everything after it."""
    b, n = scores_s.shape
    words = -(-n // WORD)
    valid = scores_s > tnms.NEG_INF / 2
    thr = torch.tensor(thr, dtype=torch.float32)
    shifts = torch.arange(WORD, dtype=torch.int64)
    area = _tri(words, words)
    space = torch.full((b * area,), -1, dtype=torch.int64)

    def packed(bits):  # (..., 64) bool -> (...) int64 word, bit j = column j
        return (bits.long() << shifts).sum(-1)

    # (a) the mask pass: row block rb against every column block cb > rb
    # (the row is the pivot), and the diagonal block as column words (the
    # earlier rank is the pivot)
    for rb in range(words):
        rows = torch.arange(rb * WORD, min(rb * WORD + WORD, n))
        iou = box_iou_corner(boxes_s[:, rows, None, :], boxes_s[:, None, :, :])
        bits = torch.nn.functional.pad(iou > thr, (0, WORD * words - n))
        bits = bits.reshape(b, len(rows), words, WORD)
        diag = bits[:, :, rb, :len(rows)]  # [i, j, k]: rank j suppresses k
        earlier = torch.arange(len(rows))[:, None] < torch.arange(len(rows))
        colw = packed(torch.nn.functional.pad(
            (diag & earlier).transpose(1, 2), (0, WORD - len(rows))))
        roww = packed(bits[:, :, rb + 1:])  # (B, rows, W - 1 - rb)
        stride = words - 1 - rb
        for i in range(b):
            for k, r in enumerate(rows.tolist()):
                if valid[i, r]:
                    chunk = i * area + _tri(rb, words)
                    space[chunk + k] = colw[i, k]
                    at = chunk + WORD + k * stride
                    space[at:at + stride] = roww[i, k]
    # (b) the scan, one image at a time, a chunk of 64 ranks at a time
    keep = torch.zeros((b, n), dtype=torch.bool)
    for i in range(b):
        v = torch.nn.functional.pad(valid[i], (0, WORD * words - n))
        removed = [ALL_ONES ^ (int(packed(v[w * WORD:(w + 1) * WORD]))
                               & ALL_ONES) for w in range(words)]
        chunks = max((w + 1 for w in range(words)
                      if removed[w] != ALL_ONES), default=0)
        count = 0
        for c in range(chunks):
            chunk = i * area + _tri(c, words)
            col = [int(x) & ALL_ONES for x in space[chunk:chunk + WORD]]
            done, kept = removed[c], 0
            while done | kept != ALL_ONES:  # one round, every rank at once
                open_ = ALL_ONES & ~(done | kept)
                ranks = [j for j in range(WORD) if open_ >> j & 1]
                kept |= sum(1 << j for j in ranks
                            if not col[j] & kept and not col[j] & open_)
                done |= sum(1 << j for j in ranks if col[j] & kept)
            kept_ranks = [j for j in range(WORD) if kept >> j & 1]
            kept_ranks = kept_ranks[:cap - count]  # the first, in rank order
            count += len(kept_ranks)
            for j in kept_ranks:
                keep[i, c * WORD + j] = True
            if count >= cap:
                break
            stride = words - 1 - c
            for w in range(c + 1, chunks):
                for j in kept_ranks:
                    removed[w] |= int(space[chunk + WORD + j * stride + w - c
                                            - 1]) & ALL_ONES
    return keep


def _wide(seed, n):
    """Boxes spread over a field that grows with n: hundreds kept at N=4097,
    so that caps of 63 and 65 fall inside chunks."""
    return _random_boxes(seed, n, spread=6 * np.sqrt(n))


@pytest.mark.parametrize("max_keep", [1, 63, 65, None])
@pytest.mark.parametrize("make", [_random_boxes, _tied, _wide])
@pytest.mark.parametrize("n", [17, 64, 65, 300, 4097])
def test_bitmask_model_matches_walk(make, n, max_keep):
    """The two-pass model against the plain walk, the JAX oracle and the
    Pallas kernel in interpret mode, bit for bit; a seventh of the ranks
    (picked at random) are padding. `None` is max_keep = N."""
    boxes, scores = make(n, n)
    scores[np.random.default_rng(n).permutation(n)[:n // 7]] = tnms.NEG_INF
    order = np.argsort(-scores, kind="stable")
    boxes, scores = boxes[order], scores[order]
    cap = n if max_keep is None else max_keep
    want = tnms.nms_keep_mask(_t(boxes)[None], _t(scores)[None], 0.5,
                              max_keep=cap, presorted=True)
    got = _bitmask_keep(_t(boxes)[None], _t(scores)[None], 0.5, min(cap, n))
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=ULP_NOTE)
    np.testing.assert_array_equal(
        got[0].numpy(), _jax_keep(boxes, scores, 0.5, max_keep=cap),
        err_msg=ULP_NOTE)
    pallas = np.asarray(nms_keep_mask_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_keep=cap,
        interpret=True, presorted=True))
    np.testing.assert_array_equal(got[0].numpy(), pallas, err_msg=ULP_NOTE)
    assert got.sum() <= cap


def test_bitmask_model_batched_with_padded_image():
    """Three images in one launch, one of them all padding."""
    boxes, scores = _batch(range(20, 23), 300, _wide)
    scores[1] = tnms.NEG_INF
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], axis=1)
    scores = np.take_along_axis(scores, order, axis=1)
    got = _bitmask_keep(_t(boxes), _t(scores), 0.4, 300)
    want = tnms.nms_keep_mask(_t(boxes), _t(scores), 0.4, presorted=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=ULP_NOTE)
    assert not got[1].any() and got[0].sum() > WORD


def _misaligned_boxes(b, n):
    flat = torch.zeros(b * n * 4 + 4)
    return flat[1:1 + b * n * 4].view(b, n, 4)


@pytest.mark.parametrize("how,name", [
    ("transposed boxes", "boxes"), ("misaligned boxes", "boxes"),
    ("strided scores", "scores"), ("column of scores", "scores")])
def test_kernel_launch_refuses_without_copying(monkeypatch, how, name):
    """The kernel's wrapper raises a ValueError naming the tensor it cannot
    read, before it builds or loads the library (no nvcc here) and without
    copying; dense inputs pass the same checks."""
    from yolo_from_scratch_tpu_torch.kernels import build

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(build, "load_library", no_library)
    boxes, scores = torch.zeros((2, 70, 4)), torch.zeros((2, 70))
    if how == "transposed boxes":
        boxes = torch.zeros((2, 4, 70)).transpose(1, 2)
    elif how == "misaligned boxes":
        boxes = _misaligned_boxes(2, 70)
    elif how == "strided scores":
        scores = torch.zeros((2, 140))[:, ::2]
    else:
        scores = torch.zeros((70, 2)).T
    with pytest.raises(ValueError, match=name):
        nms_cuda._launch_keep_mask(boxes, scores, 0.5, 70)


def test_main_path_candidates_pass_the_kernel_checks():
    """What the serving path hands the kernel (class-offset boxes, a top-k
    slice of the sorted scores) is dense and aligned as it stands."""
    boxes, scores = _random_boxes(9, 300)
    classes = torch.from_numpy(
        np.random.default_rng(9).integers(0, 3, 300).astype(np.int32))
    top, idx = tnms.sort_desc(_t(scores))
    off = tnms._class_offset_boxes(_t(boxes)[idx[:256]], classes[idx[:256]])
    nms_cuda.check_operand(off[None], "boxes", 16)
    nms_cuda.check_operand(top[:256][None], "scores", 4)
    with pytest.raises(ValueError, match="boxes"):
        nms_cuda.check_operand(_misaligned_boxes(1, 8), "boxes", 16)
