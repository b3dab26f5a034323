"""The port stands on its own: it imports nothing of the JAX package, its
copies of the JAX package's host code give the same results, and its
entry points run on the card unless asked otherwise.

Import isolation is checked in a fresh process (every module of
``toist_tpu_torch``, walked with ``pkgutil``) and, for ``chip_smoke.py``,
on its import statements read with ``ast``. Each copy (config, tokenizer,
transforms, positive maps, cocotasks, batcher, fixtures, RLE on the native
library, the synthetic reference state dict, the COCO evaluator and the
task evaluator, the TensorBoard writer and the JSONL logger) is held to the
JAX package's function on the same seeded inputs: exactly, since the copies
run the same code. The native library's build is held to its rule of one build, renamed
into place, under parallel processes.
"""
import ast
import dataclasses
import filecmp
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from toist_tpu import config as jconfig
from toist_tpu.data import batcher as jbatcher
from toist_tpu.data import cocotasks as jcocotasks
from toist_tpu.data import fixtures as jfixtures
from toist_tpu.data import positive_map as jpositive
from toist_tpu.data import transforms as jtransforms
from toist_tpu.data.tokenizer import RobertaBPE as JaxBPE
from toist_tpu.eval import coco_eval as jcoco_eval
from toist_tpu.eval import evaluator as jevaluator
from toist_tpu.ops import rle as jrle
from toist_tpu.utils import convert as jconvert
from toist_tpu.utils import logging as jlogging
from toist_tpu.utils import tensorboard as jtensorboard
from toist_tpu_torch import config as pconfig
from toist_tpu_torch.data import batcher as pbatcher
from toist_tpu_torch.data import cocotasks as pcocotasks
from toist_tpu_torch.data import fixtures as pfixtures
from toist_tpu_torch.data import positive_map as ppositive
from toist_tpu_torch.data import transforms as ptransforms
from toist_tpu_torch.data.tokenizer import RobertaBPE as PortBPE
from toist_tpu_torch.eval import coco_eval as pcoco_eval
from toist_tpu_torch.eval import evaluator as pevaluator
from toist_tpu_torch.ops import rle as prle
from toist_tpu_torch.utils import convert as pconvert
from toist_tpu_torch.utils import logging as plogging
from toist_tpu_torch.utils import tensorboard as ptensorboard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cv2 is not on the card's machine: visualize draws with numpy and PIL.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "toist_tpu", "cv2")

# The unicode cases of tests/test_tokenizer_parity.py.
UNICODE_TEXTS = [
    "pour café with crème brûlée",
    "open bottle of Bier with Flaschenöffner",
    "dig hole with   shovel",
    "use 北京 chopsticks with 茶",
    "price 3.14€ isn't £42",
    "naïve señor's piñata",
    "emoji 🔥 and ß",
]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _imports(path=os.path.join(REPO, "chip_smoke.py")):
    """Every module an import statement of ``path`` names, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module)
    return found


# What serving never runs: the training stack below the train steps.
TRAINING = ("toist_tpu_torch.train.step", "toist_tpu_torch.train.criterion",
            "toist_tpu_torch.train.optim", "toist_tpu_torch.train.state",
            "toist_tpu_torch.train.distill", "toist_tpu_torch.parallel.data")


@pytest.mark.parametrize("what", ["package", "chip_smoke", "predict"])
def test_port_imports_nothing_of_jax(what):
    if what == "chip_smoke":
        found = _imports()
        assert "toist_tpu_torch.ops.flash_attention" in found
        assert not [m for m in found if _forbidden(m)]
        return
    if what == "predict":
        # The serving API stands below the training stack, too.
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, toist_tpu_torch.predict\n"
             "print(' '.join(sorted(sys.modules)))"], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        loaded = set(proc.stdout.split())
        assert not loaded & set(TRAINING), sorted(loaded & set(TRAINING))
        assert not [m for m in loaded if _forbidden(m)]
        assert "toist_tpu_torch.infer" in loaded
        return
    code = (
        "import importlib, pkgutil, sys\n"
        "import toist_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    toist_tpu_torch.__path__, 'toist_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30      # every module was walked
    # ... and no forbidden import (cv2 among them) hides inside a function,
    # as the entry points' and scripts' imports do.
    pkg = os.path.join(REPO, "toist_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                found = _imports(os.path.join(dirpath, f))
                assert not [m for m in found if _forbidden(m)], f


@pytest.mark.parametrize("owner", ["Predictor", "TOIST",
                                   "Predictor.from_checkpoint", "visualize"])
def test_from_state_dict_defaults_to_the_card(owner):
    from toist_tpu_torch.models.toist import TOIST
    from toist_tpu_torch.predict import Predictor
    from toist_tpu_torch.visualize import visualize

    fn = {"Predictor": Predictor.from_state_dict,
          "TOIST": TOIST.from_state_dict,
          "Predictor.from_checkpoint": Predictor.from_checkpoint,
          "visualize": visualize}[owner]
    sig = inspect.signature(fn)
    assert sig.parameters["device"].default == "cuda"


@pytest.fixture(scope="module")
def tokenizers():
    corpus = jfixtures.fixture_captions() + UNICODE_TEXTS
    assert corpus == pfixtures.fixture_captions() + UNICODE_TEXTS
    return (JaxBPE.train(corpus, vocab_size=700),
            PortBPE.train(corpus, vocab_size=700))


@pytest.mark.parametrize("texts", ["fixture_captions", "unicode"])
def test_tokenizer_matches(tokenizers, texts):
    jtok, ptok = tokenizers
    assert ptok.vocab_size == jtok.vocab_size
    items = (jfixtures.fixture_captions() if texts == "fixture_captions"
             else UNICODE_TEXTS)
    for text in items:
        a, b = jtok.encode(text), ptok.encode(text)
        assert (a.input_ids, a.starts, a.ends) == \
            (b.input_ids, b.starts, b.ends), text


def _text_target(caption, tokens_positive):
    return {"caption": caption, "tokens_positive": tokens_positive,
            "noun_tokens_positive": [[sp[0]] for sp in tokens_positive]}


@pytest.mark.parametrize("case", range(4))
def test_finalize_text_and_positive_maps_match(tokenizers, case):
    jtok, ptok = tokenizers
    caption = list(jcocotasks.TASKS.values())[case] + "bottle opener"
    b = caption.find("bottle")
    spans = [[[b, b + 6]], [[b, len(caption)]], [[0, 3], [b, b + 6]],
             [[len(caption) + 2, len(caption) + 5]]][: case + 1]
    want = jcocotasks.finalize_text(_text_target(caption, spans), jtok,
                                    num_cols=64, max_text_len=16)
    got = pcocotasks.finalize_text(_text_target(caption, spans), ptok,
                                   num_cols=64, max_text_len=16)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    np.testing.assert_array_equal(
        ppositive.create_positive_map(ptok.encode(caption), spans, 32),
        jpositive.create_positive_map(jtok.encode(caption), spans, 32))
    assert pcocotasks.TASKS == jcocotasks.TASKS


@pytest.mark.parametrize("kind", ["default", "train"])
def test_buckets_match(kind):
    if kind == "default":
        for args in ((1333, 800), (1344, 800), (640, 480)):
            assert pbatcher.default_buckets(*args) == \
                jbatcher.default_buckets(*args)
    else:
        for args in ((1333, (480, 512, 800)), (1344, (480, 640, 832)),
                     (256, (160,))):
            assert pbatcher.train_buckets(*args) == \
                jbatcher.train_buckets(*args)


@pytest.mark.parametrize("config_file", [None, "configs/tdod.json"])
def test_config_matches(config_file):
    path = os.path.join(REPO, config_file) if config_file else None
    over = {"model": {"dropout": 0.2}, "data": {"max_text_len": 32}}
    for o in (None, over):
        assert dataclasses.asdict(pconfig.Config.from_sources(path, o)) == \
            dataclasses.asdict(jconfig.Config.from_sources(path, o))


@pytest.mark.parametrize("size", [(120, 160), (333, 251)])
def test_resize_and_to_array_match(size):
    rng = np.random.default_rng(size[0])
    img = Image.fromarray(rng.integers(0, 256, size + (3,), np.uint8))
    target = {"boxes": np.float32([[3, 4, 50, 60], [10, 0, 90, 100]]),
              "area": np.float32([2000, 8000])}
    for args in ((96, 128), ((64, 48), None), (200, 256)):
        a_img, a_t = jtransforms.resize(img, target, *args)
        b_img, b_t = ptransforms.resize(img, target, *args)
        assert a_img.size == b_img.size
        a_arr, a_t2 = jtransforms.to_array_u8(a_img, a_t)
        b_arr, b_t2 = ptransforms.to_array_u8(b_img, b_t)
        np.testing.assert_array_equal(b_arr, a_arr)
        for k in a_t2:
            np.testing.assert_array_equal(b_t2[k], a_t2[k], err_msg=k)
    np.testing.assert_array_equal(ptransforms._NORM_SCALE,
                                  jtransforms._NORM_SCALE)
    np.testing.assert_array_equal(ptransforms._NORM_SHIFT,
                                  jtransforms._NORM_SHIFT)


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.funny_files)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, mismatch
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


def test_fixture_files_match_byte_for_byte(tmp_path):
    kw = dict(num_tasks=2, imgs_per_split=3, img_size=(96, 128), seed=7)
    jfixtures.generate_fixture(str(tmp_path / "jax"), **kw)
    pfixtures.generate_fixture(str(tmp_path / "port"), **kw)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("masks", [False, True])
def test_dataset_batches_match(tmp_path, tokenizers, masks):
    """cocotasks (targets, captions, polygon masks through RLE), the
    transforms with their rng, and BatchIterator / collate."""
    jtok, ptok = tokenizers
    root = jfixtures.generate_fixture(str(tmp_path), num_tasks=1,
                                      imgs_per_split=4, img_size=(96, 128))
    over = {"data": {"coco_path": root,
                     "refexp_ann_path": os.path.join(root, "annotations"),
                     "tasks": [1], "train_scales": [96, 128],
                     "max_size": 192}}
    batches = []
    for cfgm, dsm, bm, tok in ((jconfig, jcocotasks, jbatcher, jtok),
                               (pconfig, pcocotasks, pbatcher, ptok)):
        d = cfgm.Config.from_sources(None, over).data
        ds = [dsm.build_task_dataset(d, 1, "train", tok, masks=masks)]
        spec = bm.BucketSpec(buckets=bm.train_buckets(d.max_size,
                                                      d.train_scales),
                             with_masks=masks)
        it = bm.BatchIterator(ds, spec, batch_size=3, seed=5, num_workers=1)
        batches.append(list(it.epoch(1, num_workers=1)))
    assert len(batches[0]) == len(batches[1]) >= 2
    for a, b in zip(*batches):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("case", ["mask", "polygons", "merge_iou"])
def test_rle_matches(case):
    rng = np.random.default_rng(3)
    m1 = (rng.uniform(size=(37, 53)) < 0.3).astype(np.uint8)
    m2 = (rng.uniform(size=(37, 53)) < 0.5).astype(np.uint8)
    if case == "mask":
        a, b = jrle.encode(m1), prle.encode(m1)
        assert a == b
        np.testing.assert_array_equal(prle.decode(b), m1)
        np.testing.assert_array_equal(prle.decode(b), jrle.decode(a))
        assert prle.area(b) == jrle.area(a) == int(m1.sum())
    elif case == "polygons":
        polys = [[5.0, 5.0, 40.0, 8.0, 30.0, 30.0, 4.0, 25.0],
                 [10.5, 2.0, 20.0, 2.0, 15.0, 12.5]]
        np.testing.assert_array_equal(prle.polygons_to_mask(polys, 37, 53),
                                      jrle.polygons_to_mask(polys, 37, 53))
    else:
        pa = [prle.encode(m) for m in (m1, m2)]
        ja = [jrle.encode(m) for m in (m1, m2)]
        for inter in (False, True):
            assert prle.merge(pa, inter) == jrle.merge(ja, inter)
        np.testing.assert_array_equal(prle.iou(pa, pa[::-1], [0, 1]),
                                      jrle.iou(ja, ja[::-1], [0, 1]))


@pytest.mark.parametrize("kw", [{}, {"with_masks": False, "enc": 2,
                                     "d": 32, "seed": 3}])
def test_synth_state_dict_matches(kw):
    a = jconvert.synth_reference_state_dict(**kw)
    b = pconvert.synth_reference_state_dict(**kw)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _seeded_detections(seed, n_img=6):
    """COCO-Tasks annotation json and detections [B, Q] (xyxy) from a seed."""
    rng = np.random.default_rng(seed)
    images = [{"id": i, "height": 96, "width": 128}
              for i in range(1, n_img + 1)]
    anns = []
    for im in images:
        for j in range(int(rng.integers(1, 4))):
            x, y = rng.uniform(0, 60, 2)
            w, h = rng.uniform(10, 60, 2)
            anns.append({"id": len(anns) + 1, "image_id": im["id"],
                         "category_id": int(rng.integers(1, 3)),
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
                         "segmentation": [[x, y, x + w, y, x + w, y + h,
                                           x, y + h]]})
    ids = np.arange(1, n_img + 1)
    scores = rng.uniform(size=(n_img, 20))
    xy = rng.uniform(0, 70, (n_img, 20, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (n_img, 20, 2))],
                           -1)
    return {"images": images, "annotations": anns}, ids, scores, boxes


@pytest.mark.parametrize("copy", ["coco_eval", "evaluator", "tensorboard",
                                  "jsonl_logger", "meter_merge"])
def test_eval_and_logging_copies_match(tmp_path, monkeypatch, copy):
    if copy == "meter_merge":
        # The cross-host merge of the meters (its transport, a gather over
        # processes, is tests/test_torch_multiprocess.py's).
        states = [{"loss": (3.0, 2), "iter_time": (0.5, 2)},
                  {"loss": (1.0, 1), "grad_norm": (2.0, 1)}]
        assert plogging.merge_meter_states(states) == \
            jlogging.merge_meter_states(states)
        summaries = []
        for mod in (jlogging, plogging):
            logger = mod.MetricLogger()
            logger.update(loss=2.0, grad_norm=0.5)
            logger.load_meter_state(mod.merge_meter_states(
                [logger.meter_state()] + states))
            logger.synchronize_between_processes()    # one process: no-op
            summaries.append(logger.summary())
        assert summaries[0] == summaries[1]
        return
    if copy in ("coco_eval", "evaluator"):
        coco, ids, scores, boxes = _seeded_detections(11)
        out = []
        for co, ev in ((jcoco_eval, jevaluator), (pcoco_eval, pevaluator)):
            gts = ev.gt_records_from_json(coco)
            if copy == "coco_eval":
                dts = [{"image_id": int(i), "category_id": 1, "score": sc,
                        "bbox": [x0, y0, x1 - x0, y1 - y0]}
                       for i, row, brow in zip(ids, scores, boxes)
                       for sc, (x0, y0, x1, y1) in zip(row, brow)]
                e = co.COCOEval(gts, dts)
                out.append([e.stats(), e.eval["precision"],
                            co.box_iou_xywh(boxes[0], boxes[1],
                                            np.zeros(20))])
            else:
                t = ev.TaskEvaluator(gts, iou_types=("bbox", "segm"),
                                     score_threshold=0.2)
                valid = np.arange(len(ids)) < len(ids) - 1
                t.update(ids, scores, boxes, valid=valid)
                t.update(ids[:2], scores[:2], boxes[:2])     # duplicates
                s = t.summarize()
                out.append([s["bbox"], s["segm"], ev.mean_ap50({1: s})])
        for a, b in zip(*out):
            np.testing.assert_array_equal(b, a)
        return
    if copy == "tensorboard":
        data = np.random.default_rng(2).bytes(300)
        assert ptensorboard.crc32c(data) == jtensorboard.crc32c(data)
        scalars = {"loss": 1.25, "map@0.5_bbox": 0.375, "01_ap@0.5": -1.0}
        for mod in (ptensorboard, jtensorboard):
            monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
        files = []
        for name, mod in (("jax", jtensorboard), ("port", ptensorboard)):
            assert mod.tfrecord(mod.encode_scalar_event(1.5, 7, scalars)) == \
                jtensorboard.tfrecord(jtensorboard.encode_scalar_event(
                    1.5, 7, scalars))
            w = mod.SummaryWriter(str(tmp_path / name))
            w.add_scalars(scalars, step=3)
            w.add_scalar("training_loss", 2.0, 4)
            files.append(w.path)
    else:
        records = [{"kind": "train_step", "epoch": 0, "step": 1,
                    "loss": np.float32(2.5)},
                   {"kind": "eval", "mean_ap50": 0.25,
                    "per_task": {1: {"bbox": [0.1, -1.0]}}}]
        files = []
        for name, mod in (("jax", jlogging), ("port", plogging)):
            log = mod.JsonlLogger(str(tmp_path / name))
            for r in records:
                log.write(r)
            files.append(log.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        assert a.read() == b.read()


def test_native_library_builds_once_under_parallel_processes(tmp_path):
    """Four processes load the native library at once into an empty build
    directory: all load it, one library file is left, no temporary file."""
    code = (
        "import sys\n"
        "from toist_tpu_torch import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "lib = native.load()\n"
        "print(lib.rle_area is not None)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert all(o.strip() == "True" for o, _ in outs)
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.endswith(".so")] == \
        [os.path.basename(_native_so_name())], files
    assert set(files) == {"lock", os.path.basename(_native_so_name())}


def _native_so_name():
    from toist_tpu_torch import native

    return native._so_path()
