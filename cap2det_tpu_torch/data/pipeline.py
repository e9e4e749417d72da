"""Host-side input pipeline: TFRecords -> fixed-shape training batches
(the port's copy of ``cap2det_tpu/data/pipeline.py``).

As in the JAX package (reference readers/cap2det_reader.py:19-269):

  * image decode, random horizontal flip with box consistency, keep-aspect
    resize onto one fixed canvas per (``batch_resize_scale_value``,
    orientation) bucket, proposal truncation and zero padding to
    ``max_num_proposals``, box renormalization to the canvas;
  * caption token buffers sliced on the host, and labels extracted there
    (``pseudo_labels``);
  * text batches for the text model (``decode_image: false``): captions
    and labels only, with the concatenated captions' token ids
    (``concat_caption_token_ids``) when a vocabulary is given;
  * the same three ``random.Random`` streams (epoch order, shuffle buffer,
    batch decisions) drawn in the same order, so both packages give the
    same batches from the same records and seed.

Records are read by the host library's TFRecord reader
(``native.read_records_native``, buffered with a readahead thread), as
the JAX feed reads them whenever its native library is built; the port
has no quiet fallback to the Python reader: a library that cannot be
built raises, and ``in_worker_process`` builds it before it starts its
worker.

The resize is cv2's fixed-point INTER_LINEAR for uint8 images, written as
integer tensor arithmetic on whatever device the image lies on, so a
canvas equals the JAX package's (``cv2.resize``) bit for bit. The feed
emits raw uint8 [B, H, W, 3] canvases: the JAX feed's space-to-depth
packing is a TPU layout that the port leaves out. PNG decodes without
Pillow (``data/png.py``); every other format needs Pillow.

Photometric augmentation (``data/augment.py``) runs before the flip, and
only with the ``enable_photometric_augmentation`` opt-in: the reference's
reader ignores those options, so without it they are refused.
"""

from __future__ import annotations

import collections
import functools
import io
import os
import queue as queue_lib
import random
import threading

import numpy as np
import torch

from cap2det_tpu_torch import native
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import augment, png, tf_example, tfrecord
from cap2det_tpu_torch.fields import InputFields, TFExampleFields
from cap2det_tpu_torch.text import extractors as extractors_lib

_WANTED_KEYS = {
    TFExampleFields.image_id,
    TFExampleFields.image_encoded,
    TFExampleFields.caption_string,
    TFExampleFields.caption_offset,
    TFExampleFields.caption_length,
    TFExampleFields.object_box_ymin,
    TFExampleFields.object_box_xmin,
    TFExampleFields.object_box_ymax,
    TFExampleFields.object_box_xmax,
    TFExampleFields.object_label,
    TFExampleFields.object_text,
    TFExampleFields.proposal_box_ymin,
    TFExampleFields.proposal_box_xmin,
    TFExampleFields.proposal_box_ymax,
    TFExampleFields.proposal_box_xmax,
}

_WANTED_KEYS_NO_IMAGE = _WANTED_KEYS - {TFExampleFields.image_encoded}


def _get(parsed, key):
    entry = parsed.get(key)
    if entry is None:
        return []
    return entry[1]


def _boxes_from(parsed, prefix):
    ymin = np.asarray(_get(parsed, prefix + "/ymin"), np.float32)
    xmin = np.asarray(_get(parsed, prefix + "/xmin"), np.float32)
    ymax = np.asarray(_get(parsed, prefix + "/ymax"), np.float32)
    xmax = np.asarray(_get(parsed, prefix + "/xmax"), np.float32)
    if not len(ymin):
        return np.zeros((0, 4), np.float32)
    return np.stack([ymin, xmin, ymax, xmax], axis=-1)


def parse_example(record, decode_image=True):
    """Parses one serialized tf.Example into a host example dict."""
    parsed = tf_example.decode_example(
        record, _WANTED_KEYS if decode_image else _WANTED_KEYS_NO_IMAGE
    )

    tokens = [b.decode("utf-8")
              for b in _get(parsed, TFExampleFields.caption_string)]
    offsets = _get(parsed, TFExampleFields.caption_offset)
    lengths = _get(parsed, TFExampleFields.caption_length)
    captions = [
        tokens[int(o): int(o) + int(n)] for o, n in zip(offsets, lengths)
    ]

    example = {
        "image_id": _get(parsed, TFExampleFields.image_id)[0].decode("utf-8"),
        "captions": captions,
        "concat_tokens": tokens,
        "proposals": _boxes_from(parsed, TFExampleFields.proposal_box),
        "object_boxes": _boxes_from(parsed, TFExampleFields.object_box),
        "object_texts": [
            b.decode("utf-8")
            for b in _get(parsed, TFExampleFields.object_text)
        ],
        "object_labels": list(_get(parsed, TFExampleFields.object_label)),
    }
    if decode_image:
        enc = _get(parsed, TFExampleFields.image_encoded)
        example["image_encoded"] = enc[0] if enc else None
    return example


def _open_with_pillow(data):
    """A Pillow image of encoded bytes that are not PNG."""
    try:
        from PIL import Image
    except ImportError as e:
        kind = "JPEG" if bytes(data[:2]) == b"\xff\xd8" else "non-PNG"
        raise ImportError(
            "decoding a %s image needs Pillow (PIL), which is not "
            "installed; PNG decodes without it" % kind) from e
    return Image.open(io.BytesIO(data))


def image_size(data):
    """(height, width) of encoded image bytes from the header alone: the
    PNG IHDR chunk directly, other formats through Pillow."""
    if png.is_png(data):
        return png.png_size(data)
    with _open_with_pillow(data) as im:
        w, h = im.size
    return h, w


def decode_jpeg(data):
    """Encoded image bytes -> [H, W, 3] uint8 RGB array: PNG through
    ``data/png.py``, other formats (JPEG) through Pillow."""
    if png.is_png(data):
        return png.decode_png(data)
    img = _open_with_pillow(data)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.array(img, dtype=np.uint8)  # writable, as torch wants


def _round_up(x, m):
    return int(-(-x // m) * m)


def compute_canvas(min_dimension, scale=1.0, aspect_cap=1.5, multiple=32):
    """Fixed (short_side, long_side) canvas for one scale bucket."""
    short = _round_up(round(min_dimension * scale), multiple)
    long = _round_up(round(min_dimension * scale * aspect_cap), multiple)
    return short, long


# cv2's INTER_RESIZE_COEF_SCALE: interpolation weights in 1/2048ths.
_COEF_SCALE = 2048


def _linear_coeffs(src, dst, clamp_weights, device):
    """cv2's fixed-point bilinear coefficients of one axis: the two source
    indices and their integer weights for each of the `dst` outputs.

    The source position is float32((d + 0.5) * src/dst - 0.5), its floor
    the first index and the rest the fraction f; the weights are 1 - f and
    f in 1/2048ths, rounded half to even. cv2 clamps the horizontal axis
    as a whole (an index outside the map moves to the edge with f = 0) but
    only the two row indices of the vertical axis, whose weights stay as
    computed (`clamp_weights` False).
    """
    scale = 1.0 / (dst / src)
    # Built on the image's device: a copy from the host would wait for the
    # work queued before it.
    pos = ((torch.arange(dst, dtype=torch.float64, device=device) + 0.5)
           * scale - 0.5).to(torch.float32)
    first = torch.floor(pos)
    frac = pos - first
    first = first.to(torch.int64)
    if clamp_weights:
        low, high = first < 0, first >= src - 1
        first = torch.where(low, 0, torch.where(high, src - 1, first))
        frac = torch.where(low | high, 0.0, frac)
    w1 = torch.round(frac * _COEF_SCALE)
    w0 = torch.round((1.0 - frac) * _COEF_SCALE)
    return (first.clamp(0, src - 1), (first + 1).clamp(0, src - 1),
            w0.to(torch.int32), w1.to(torch.int32))


def resize_bilinear_u8(image, new_h, new_w):
    """[H, W, C] uint8 tensor -> [new_h, new_w, C] uint8, bit for bit as
    ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)``: a horizontal pass
    into int32 (weights sum to 2048), then cv2's SIMD vertical pass,
    ((b0 * (H0 >> 4)) >> 16) + ((b1 * (H1 >> 4)) >> 16) rounded by
    (+ 2) >> 2."""
    h, w = image.shape[:2]
    x0, x1, a0, a1 = _linear_coeffs(w, new_w, True, image.device)
    y0, y1, b0, b1 = _linear_coeffs(h, new_h, False, image.device)
    src = image.to(torch.int32)
    # In place wherever a temporary can be reused: on the CPU each fresh
    # canvas-sized tensor costs its page faults as well as its pass.
    rows = src[:, x0].mul_(a0[:, None]).add_(src[:, x1].mul_(a1[:, None]))
    rows.bitwise_right_shift_(4)
    out = rows[y0].mul_(b0[:, None, None]).bitwise_right_shift_(16)
    out.add_(rows[y1].mul_(b1[:, None, None]).bitwise_right_shift_(16))
    return out.add_(2).bitwise_right_shift_(2).clamp_(0, 255).to(torch.uint8)


def resize_to_canvas(image, canvas_hw):
    """Keep-aspect resize so min-dim hits the canvas short side (or the
    image fits, whichever is smaller).

    Args:
      image: [H, W, 3] uint8 tensor or array.

    Returns:
      (resized [new_h, new_w, 3] uint8 tensor on the image's device,
      (new_h, new_w)).
    """
    image = torch.as_tensor(image)
    if image.dtype != torch.uint8:
        raise TypeError("resize_to_canvas: uint8 image expected, got %s"
                        % image.dtype)
    ch, cw = canvas_hw
    h, w = image.shape[:2]
    target = min(ch, cw) / min(h, w)
    scale = min(target, ch / h, cw / w)
    new_h = max(1, min(ch, int(round(h * scale))))
    new_w = max(1, min(cw, int(round(w * scale))))
    return resize_bilinear_u8(image, new_h, new_w), (new_h, new_w)


def fit_image_to_canvas(image, canvas_hw):
    """resize_to_canvas + top-left placement on a zero uint8 canvas.

    Returns (canvas [ch, cw, 3] uint8 tensor, (new_h, new_w)).
    """
    resized, (new_h, new_w) = resize_to_canvas(image, canvas_hw)
    ch, cw = canvas_hw
    canvas = torch.zeros((ch, cw, 3), dtype=torch.uint8, device=resized.device)
    canvas[:new_h, :new_w] = resized
    return canvas, (new_h, new_w)


def _flip_boxes(boxes):
    if not len(boxes):
        return boxes
    ymin, xmin, ymax, xmax = boxes.T
    return np.stack([ymin, 1.0 - xmax, ymax, 1.0 - xmin], axis=-1)


def _shard_hash(image_id, denom):
    return tfrecord.crc32c(image_id.encode("utf-8")) % denom


def _parallel_map(fn, iterable, workers, extra_inflight=2):
    """Order-preserving parallel map over a (possibly infinite) stream.

    Keeps at most ``workers + extra_inflight`` items in flight —
    ThreadPoolExecutor.map would consume the whole iterator eagerly,
    which never terminates on a repeating training stream.
    """
    from concurrent.futures import ThreadPoolExecutor

    it = iter(iterable)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = collections.deque()
        try:
            for _ in range(workers + extra_inflight):
                pending.append(pool.submit(fn, next(it)))
        except StopIteration:
            it = None
        while pending:
            result = pending.popleft().result()
            if it is not None:
                try:
                    pending.append(pool.submit(fn, next(it)))
                except StopIteration:
                    it = None
            yield result


def labels_for_examples(extractor, examples):
    """Runs the label extractor over a list of host examples.

    Groundtruth extraction reads object texts; the caption extractors read
    the concatenated caption token buffer (reference cap2det_model.py:292
    via label_extractor input fields).
    """
    if isinstance(extractor, extractors_lib.GroundtruthExtractor):
        texts = [ex["object_texts"] for ex in examples]
    else:
        texts = [ex["concat_tokens"] for ex in examples]
    return extractor.extract_labels(texts)


class InputPipeline:
    """Iterable over fixed-shape image batches (numpy arrays).

    Args:
      options: schema.Cap2DetReader.
      label_extractor: optional extractor; adds `pseudo_labels` to batches.
      vocab: optional text Vocabulary; adds `concat_caption_token_ids`.
      seed: python RNG seed for shuffling/flip/scale decisions.
      aspect_cap / canvas_multiple: canvas bucket geometry.
      bucket_by_orientation: separate landscape/portrait batches.
      prefetch: batches a background thread keeps ready (0: none).
      max_caption_tokens: length of the concatenated token-id field.
    """

    def __init__(
        self,
        options: schema.Cap2DetReader,
        label_extractor=None,
        vocab=None,
        seed=0,
        aspect_cap=1.5,
        canvas_multiple=32,
        bucket_by_orientation=True,
        prefetch=2,
        max_caption_tokens=64,
    ):
        if not isinstance(options, schema.Cap2DetReader):
            raise ValueError("options must be a Cap2DetReader config")
        self.options = options
        self.label_extractor = label_extractor
        self.vocab = vocab
        self.max_caption_tokens = max_caption_tokens
        self.seed = seed
        self.aspect_cap = aspect_cap
        self.canvas_multiple = canvas_multiple
        self.bucket_by_orientation = bucket_by_orientation
        self.prefetch = prefetch

        self._min_dimension = 600
        self._fixed_hw = None
        resizer = options.image_resizer
        if resizer is not None:
            which = resizer.which_oneof()
            if which == "keep_aspect_ratio_resizer":
                self._min_dimension = (
                    resizer.keep_aspect_ratio_resizer.min_dimension)
            elif which == "fixed_shape_resizer":
                self._fixed_hw = (
                    resizer.fixed_shape_resizer.height,
                    resizer.fixed_shape_resizer.width,
                )

        preprocess = options.preprocess_options
        if preprocess is not None and preprocess.random_crop_prob > 0:
            # The reference's cap2det reader path uses the flip-only v2
            # preprocess (core/preprocess.py:56-78); random_crop belongs
            # to the v1 chain no reader calls.
            raise ValueError(
                "random_crop_prob is not supported by the cap2det reader "
                "(the reference's v2 preprocess path is flip-only)"
            )
        if (augment.has_photometric(preprocess)
                and not preprocess.enable_photometric_augmentation):
            # The reference's reader would silently ignore these knobs.
            raise ValueError(
                "photometric preprocess options are ignored by the "
                "reference's cap2det reader (flip-only v2 path); set "
                "enable_photometric_augmentation: true to opt in to "
                "this framework's extension"
            )

        self._scales = list(options.batch_resize_scale_value) or [1.0]
        self._shard = None
        if options.shard_indicator:
            numer, denom = options.shard_indicator.split("/")
            self._shard = (int(numer), int(denom))
            if not 0 <= self._shard[0] < self._shard[1]:
                raise ValueError(
                    "bad shard_indicator %r" % options.shard_indicator)

    # -- raw example stream ---------------------------------------------------

    def _file_list(self):
        patterns = self.options.input_pattern
        if isinstance(patterns, (str, bytes)):
            # Guard against a bare-string assignment to the repeated field:
            # list("path") would glob per character and silently match "/".
            patterns = [patterns]
        files = tfrecord.list_files(list(patterns))
        if not files:
            raise FileNotFoundError(
                "no files match %s" % list(self.options.input_pattern)
            )
        return files

    def example_stream(self):
        """Yields parsed host examples (single pass unless training)."""
        rng = random.Random(self.seed)
        is_training = self.options.is_training
        files = self._file_list()
        while True:
            ordered = list(files)
            if is_training:
                rng.shuffle(ordered)
            yielded = 0
            for path in ordered:
                for record in native.read_records_native(path):
                    example = parse_example(record, self.options.decode_image)
                    if self._shard is not None:
                        numer, denom = self._shard
                        if _shard_hash(example["image_id"], denom) != numer:
                            continue
                    yielded += 1
                    yield example
            if not is_training:
                return
            if yielded == 0:
                # Spinning epochs over an empty dataset would hang training
                # silently; fail loudly instead.
                raise RuntimeError(
                    "input files %r contain no (unfiltered) examples" % files
                )

    def _shuffled_stream(self):
        """Reservoir-style shuffle buffer (mirrors dataset.shuffle)."""
        if not self.options.is_training or self.options.shuffle_buffer_size <= 1:
            yield from self.example_stream()
            return
        rng = random.Random(self.seed + 1)
        buf = []
        size = self.options.shuffle_buffer_size
        for ex in self.example_stream():
            buf.append(ex)
            if len(buf) >= size:
                idx = rng.randrange(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    # -- batching --------------------------------------------------------------

    def _encode_captions(self, examples):
        """[B, max_caption_tokens] int32 token ids (pad = OOV id)."""
        out = np.full((len(examples), self.max_caption_tokens),
                      self.vocab.oov_id, dtype=np.int32)
        for i, ex in enumerate(examples):
            toks = ex["concat_tokens"][: self.max_caption_tokens]
            for j, t in enumerate(toks):
                out[i, j] = self.vocab.lookup(t)
        return out

    def _caption_matrix(self, examples):
        """Padded per-caption string fields (mirrors parse_texts output)."""
        num = max((len(ex["captions"]) for ex in examples), default=0)
        maxlen = max(
            (len(c) for ex in examples for c in ex["captions"]), default=0
        )
        strings = np.full((len(examples), num, maxlen), "", dtype=object)
        lengths = np.zeros((len(examples), num), np.int64)
        counts = np.zeros((len(examples),), np.int32)
        for i, ex in enumerate(examples):
            counts[i] = len(ex["captions"])
            for j, cap in enumerate(ex["captions"]):
                lengths[i, j] = len(cap)
                for k, t in enumerate(cap):
                    strings[i, j, k] = t
        return counts, strings, lengths

    def _assemble_text_batch(self, examples):
        batch = {
            InputFields.image_id: [ex["image_id"] for ex in examples],
            InputFields.object_texts: [ex["object_texts"] for ex in examples],
            "concat_tokens": [ex["concat_tokens"] for ex in examples],
        }
        counts, strings, lengths = self._caption_matrix(examples)
        batch[InputFields.num_captions] = counts
        batch[InputFields.caption_strings] = strings
        batch[InputFields.caption_lengths] = lengths
        if self.vocab is not None:
            batch[InputFields.concat_caption_token_ids] = (
                self._encode_captions(examples))
        if self.label_extractor is not None:
            batch[InputFields.pseudo_labels] = labels_for_examples(
                self.label_extractor, examples
            )
        return batch

    def _prep_example(self, task):
        """Heavy per-example work: decode, photometric, flip, canvas fit,
        box renormalization. All randomness was pre-drawn in the serial
        pre-stage (task fields), so this runs on the parallel-map threads
        with deterministic output regardless of thread timing. The work is
        numpy and CPU tensors only: CUDA stays on the consumer's thread."""
        ex, (ch, cw) = task["ex"], task["canvas_hw"]
        image = decode_jpeg(ex["image_encoded"])
        if task["photo_seed"] is not None:
            image = augment.apply_photometric(
                image, self.options.preprocess_options,
                random.Random(task["photo_seed"]))
        flip = task["flip"]
        if flip:
            # A flip is a negative-stride view, which torch.as_tensor
            # refuses.
            image = np.ascontiguousarray(image[:, ::-1])
        canvas, (new_h, new_w) = fit_image_to_canvas(image, (ch, cw))

        props = ex["proposals"][: self.options.max_num_proposals]
        obj = ex["object_boxes"]
        if flip:
            props = _flip_boxes(props)
            obj = _flip_boxes(obj)
        # Renormalize from true image extent to canvas extent
        # (reference _batch_scale_box_fn semantics), in float32 numpy.
        fy, fx = new_h / ch, new_w / cw
        scale_vec = np.array([fy, fx, fy, fx], np.float32)
        ex["_canvas"] = canvas.numpy()
        ex["_new_hw"] = (new_h, new_w)
        ex["_props_canvas"] = props * scale_vec
        ex["_obj_canvas"] = obj * scale_vec if len(obj) else obj
        return ex

    def _stack_image_batch(self, examples):
        """Stacks prepped examples into the padded batch."""
        opt = self.options
        batch = self._assemble_text_batch(examples)
        canvas0 = examples[0]["_canvas"]
        images = np.empty((len(examples),) + canvas0.shape, canvas0.dtype)
        image_shapes = np.zeros((len(examples), 3), np.int32)
        proposals = np.zeros((len(examples), opt.max_num_proposals, 4),
                             np.float32)
        num_proposals = np.zeros((len(examples),), np.int32)
        object_boxes = []
        for i, ex in enumerate(examples):
            images[i] = ex["_canvas"]
            new_h, new_w = ex["_new_hw"]
            image_shapes[i] = (new_h, new_w, 3)
            props = ex["_props_canvas"]
            proposals[i, : len(props)] = props
            num_proposals[i] = len(props)
            object_boxes.append(ex["_obj_canvas"])

        batch.update(
            {
                InputFields.image: images,
                InputFields.image_shape: image_shapes,
                InputFields.proposals: proposals,
                InputFields.num_proposals: num_proposals,
                InputFields.object_boxes: object_boxes,
                InputFields.num_objects: np.array(
                    [len(b) for b in object_boxes], np.int32
                ),
            }
        )
        return batch

    def __iter__(self):
        return self._prefetched(self._batches())

    def _batches(self):
        opt = self.options
        rng = random.Random(self.seed + 2)
        batch_size = opt.batch_size

        if not opt.decode_image:
            pending = []
            for ex in self._shuffled_stream():
                pending.append(ex)
                if len(pending) == batch_size:
                    yield self._assemble_text_batch(pending)
                    pending = []
            # Trailing partial batch dropped: reference padded_batch uses
            # drop_remainder=True (cap2det_reader.py:252).
            return

        # Serial pre-stage: read image dims (header only — no pixel
        # decode), assign bucket / per-batch scale / flip / photometric
        # seeds in stream order so all randomness is deterministic under
        # `seed`, then fan the heavy decode+augment+fit out to
        # `map_num_parallel_calls` threads (order-preserving).
        flip_prob = 0.0
        if opt.is_training and opt.preprocess_options is not None:
            flip_prob = opt.preprocess_options.random_flip_left_right_prob
        photometric = (opt.is_training
                       and augment.has_photometric(opt.preprocess_options))
        bucket_counts = {}
        bucket_scale = {}

        def tasks():
            for ex in self._shuffled_stream():
                if ex.get("image_encoded") is None:
                    continue
                h, w = image_size(ex["image_encoded"])
                landscape = w >= h
                key = (
                    landscape
                    if (self.bucket_by_orientation and self._fixed_hw is None)
                    else True
                )
                idx = bucket_counts.get(key, 0)
                bucket_counts[key] = idx + 1
                if idx % batch_size == 0:
                    # Batch-level decisions, fixed by the batch's first
                    # example.
                    bucket_scale[key] = (
                        (rng.choice(self._scales) if opt.is_training else 1.0),
                        landscape,
                    )
                scale, batch_landscape = bucket_scale[key]
                if self._fixed_hw is not None:
                    ch = _round_up(self._fixed_hw[0] * scale,
                                   self.canvas_multiple)
                    cw = _round_up(self._fixed_hw[1] * scale,
                                   self.canvas_multiple)
                else:
                    short, long = compute_canvas(
                        self._min_dimension, scale, self.aspect_cap,
                        self.canvas_multiple,
                    )
                    ch, cw = (
                        (short, long) if batch_landscape else (long, short)
                    )
                yield {
                    "ex": ex,
                    "key": key,
                    "canvas_hw": (ch, cw),
                    "flip": opt.is_training and rng.random() < flip_prob,
                    "photo_seed": rng.getrandbits(64) if photometric else None,
                }

        # Cap at the host's core count: with fewer cores than workers the
        # interpreter lock and memory bandwidth make threads a loss.
        workers = max(1, min(opt.map_num_parallel_calls, os.cpu_count() or 1))
        if workers > 1:
            prepped = _parallel_map(
                lambda t: (t["key"], self._prep_example(t)), tasks(), workers
            )
        else:
            prepped = ((t["key"], self._prep_example(t)) for t in tasks())

        buckets = {}
        for key, ex in prepped:
            buckets.setdefault(key, []).append(ex)
            if len(buckets[key]) == batch_size:
                yield self._stack_image_batch(buckets[key])
                buckets[key] = []
        # Trailing partial buckets dropped: reference padded_batch uses
        # drop_remainder=True (cap2det_reader.py:252).

    def _prefetched(self, gen):
        if self.prefetch <= 0:
            yield from gen
            return
        q = queue_lib.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []
        stop = threading.Event()

        def put(item):
            # Bounded put that aborts when the consumer abandoned the
            # iterator — a plain q.put would block forever, leaking the
            # thread, a batch, and the open record file.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue_lib.Full:
                    continue
            return False

        def worker():
            try:
                for item in gen:
                    if not put(item):
                        return
            except BaseException as e:  # propagate to consumer
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            # At most the batch in hand: a thread left running torch work
            # would abort a worker process's interpreter at exit.
            t.join()


class _Batches(torch.utils.data.IterableDataset):
    """An input pipeline's batches, as the dataset a worker iterates."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __iter__(self):
        batches = iter(self.pipe)
        try:
            for batch in batches:
                # A tensor crosses to the caller in shared memory, an
                # array through a pipe. A text batch has no canvas.
                if InputFields.image in batch:
                    batch[InputFields.image] = torch.from_numpy(
                        batch[InputFields.image])
                yield batch
        finally:
            batches.close()


def _set_threads(threads, worker_id):
    torch.set_num_threads(threads)


def _as_is(batch):
    return batch


def in_worker_process(pipe, device):
    """Yields `pipe`'s batches, made in one worker process: spawned, so it
    shares no interpreter lock with the caller and starts its own thread
    pools, with as many intra-op threads as the caller has. A batch's
    canvas, where it has one, arrives as a CPU tensor in shared memory;
    for a CUDA `device` a thread of the caller's copies it into
    page-locked memory. The other fields are the pipeline's. Closing the generator stops the worker.

    The host library the feed reads records with is loaded here first, so
    that a build at first use happens once, in this process, and the
    worker only loads it."""
    device = torch.device(device)
    native.load()
    loader = torch.utils.data.DataLoader(
        _Batches(pipe), batch_size=None, num_workers=1, prefetch_factor=2,
        multiprocessing_context="spawn", collate_fn=_as_is,
        worker_init_fn=functools.partial(_set_threads,
                                         torch.get_num_threads()),
        pin_memory=device.type == "cuda")
    batches = iter(loader)
    try:
        yield from batches
    finally:
        del batches  # the DataLoader's iterator joins its worker when freed


def build_input_pipeline(reader_config: schema.Reader, **kwargs):
    """Factory from the Reader oneof (mirrors readers/reader.py:11-28)."""
    which = reader_config.which_oneof()
    if which == "cap2det_reader":
        return InputPipeline(reader_config.cap2det_reader, **kwargs)
    raise ValueError("unknown reader %r" % which)
