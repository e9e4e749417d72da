"""Typed configuration schema.

The port's own copy of ``cap2det_tpu/config/schema.py``. Mirrors the
reference proto2 schemas (pipeline.proto, reader.proto, model.proto +
cap2det_model.proto, optimizer.proto, hyperparams.proto, frcnn.proto,
label_extractor.proto, post_process.proto, image_resizer.proto,
preprocess.proto) as frozen-ish
dataclasses with identical field names and defaults, so all nine shipped
pbtxt experiment configs parse verbatim.

Oneofs are modeled as a set of Optional fields plus a `which_*` helper.
Presence semantics (`HasField`) are modeled by tracking which keys appeared
in the parsed dict (see `Config._present`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cap2det_tpu_torch.config import pbtxt


class ConfigError(ValueError):
    pass


@dataclass
class Config:
    """Base class adding presence tracking and dict construction."""

    def __post_init__(self):
        object.__setattr__(self, "_present", set())

    def has_field(self, name):
        return name in getattr(self, "_present", set())

    @classmethod
    def from_dict(cls, d):
        if d is None:
            d = {}
        if not isinstance(d, dict):
            raise ConfigError("%s expects a message, got %r" % (cls.__name__, d))
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(d) - set(fields) - set(getattr(cls, "_EXTENSIONS", {}))
        if unknown:
            raise ConfigError("%s: unknown fields %s" % (cls.__name__, sorted(unknown)))
        for name, f in fields.items():
            if name not in d:
                continue
            raw = d[name]
            kwargs[name] = _convert(f, raw, cls.__name__)
        obj = cls(**kwargs)
        object.__setattr__(obj, "_present", set(kwargs))
        # Extensions (e.g. '[Cap2DetModel.ext]') are routed to a dedicated
        # field by subclasses that define _EXTENSIONS.
        for ext_key, (attr, ext_cls) in getattr(cls, "_EXTENSIONS", {}).items():
            if ext_key in d:
                object.__setattr__(obj, attr, ext_cls.from_dict(d[ext_key]))
                obj._present.add(attr)
        return obj


def _convert(f, raw, ctx):
    meta = f.metadata
    kind = meta.get("kind", "scalar")
    if kind == "message":
        sub = meta["cls"]
        if isinstance(raw, pbtxt.RepeatedValue):
            raise ConfigError("%s.%s: not repeated" % (ctx, f.name))
        return sub.from_dict(raw)
    if kind == "repeated_message":
        sub = meta["cls"]
        return [sub.from_dict(x) for x in pbtxt.as_list(raw)]
    if kind == "repeated":
        typ = meta.get("type")
        vals = pbtxt.as_list(raw)
        return [_coerce(v, typ, ctx, f.name) for v in vals]
    # scalar
    if isinstance(raw, pbtxt.RepeatedValue):
        raise ConfigError("%s.%s: not repeated" % (ctx, f.name))
    return _coerce(raw, meta.get("type"), ctx, f.name)


def _coerce(v, typ, ctx, name):
    if typ is None:
        return v
    if typ is float and isinstance(v, (int, bool)):
        return float(v)
    if typ is int and isinstance(v, bool):
        return int(v)
    if typ is str and not isinstance(v, str):
        raise ConfigError("%s.%s: expected string, got %r" % (ctx, name, v))
    if not isinstance(v, typ):
        raise ConfigError("%s.%s: expected %s, got %r" % (ctx, name, typ, v))
    return v


def scalar(typ, default=None):
    return field(default=default, metadata={"kind": "scalar", "type": typ})


def enum(default=None):
    return field(default=default, metadata={"kind": "scalar", "type": str})


def repeated(typ):
    return field(default_factory=list, metadata={"kind": "repeated", "type": typ})


def message(cls, default_factory=None):
    if default_factory is None:
        return field(default=None, metadata={"kind": "message", "cls": cls})
    return field(default_factory=default_factory, metadata={"kind": "message", "cls": cls})


def repeated_message(cls):
    return field(default_factory=list, metadata={"kind": "repeated_message", "cls": cls})


def _which(obj, names):
    present = [n for n in names if obj.has_field(n) and getattr(obj, n) is not None]
    if len(present) > 1:
        raise ConfigError("oneof: multiple fields set: %s" % present)
    return present[0] if present else None


# ---------------------------------------------------------------------------
# optimizer.proto
# ---------------------------------------------------------------------------


@dataclass
class GradientDescentOptimizer(Config):
    use_locking: bool = scalar(bool, False)


@dataclass
class AdagradOptimizer(Config):
    initial_accumulator_value: float = scalar(float, 0.1)
    use_locking: bool = scalar(bool, False)


@dataclass
class AdamOptimizer(Config):
    beta1: float = scalar(float, 0.9)
    beta2: float = scalar(float, 0.999)
    epsilon: float = scalar(float, 1e-8)
    use_locking: bool = scalar(bool, False)


@dataclass
class RMSPropOptimizer(Config):
    decay: float = scalar(float, 0.9)
    momentum: float = scalar(float, 0.0)
    epsilon: float = scalar(float, 1e-10)
    use_locking: bool = scalar(bool, False)
    centered: bool = scalar(bool, False)


@dataclass
class MomentumOptimizer(Config):
    momentum: float = scalar(float, 0.0)
    use_locking: bool = scalar(bool, False)
    use_nesterov: bool = scalar(bool, False)


@dataclass
class Optimizer(Config):
    sgd: Optional[GradientDescentOptimizer] = message(GradientDescentOptimizer)
    adagrad: Optional[AdagradOptimizer] = message(AdagradOptimizer)
    adam: Optional[AdamOptimizer] = message(AdamOptimizer)
    rmsprop: Optional[RMSPropOptimizer] = message(RMSPropOptimizer)
    momentum: Optional[MomentumOptimizer] = message(MomentumOptimizer)

    def which_oneof(self):
        return _which(self, ["sgd", "adagrad", "adam", "rmsprop", "momentum"])


# ---------------------------------------------------------------------------
# hyperparams.proto
# ---------------------------------------------------------------------------


@dataclass
class L1Regularizer(Config):
    weight: float = scalar(float, 1.0)


@dataclass
class L2Regularizer(Config):
    weight: float = scalar(float, 1.0)


@dataclass
class Regularizer(Config):
    l1_regularizer: Optional[L1Regularizer] = message(L1Regularizer)
    l2_regularizer: Optional[L2Regularizer] = message(L2Regularizer)

    def which_oneof(self):
        return _which(self, ["l1_regularizer", "l2_regularizer"])


@dataclass
class TruncatedNormalInitializer(Config):
    mean: float = scalar(float, 0.0)
    stddev: float = scalar(float, 1.0)


@dataclass
class VarianceScalingInitializer(Config):
    factor: float = scalar(float, 2.0)
    uniform: bool = scalar(bool, False)
    mode: str = enum("FAN_IN")


@dataclass
class RandomNormalInitializer(Config):
    mean: float = scalar(float, 0.0)
    stddev: float = scalar(float, 1.0)


@dataclass
class GlorotNormalInitializer(Config):
    pass


@dataclass
class GlorotUniformInitializer(Config):
    pass


@dataclass
class Initializer(Config):
    truncated_normal_initializer: Optional[TruncatedNormalInitializer] = message(
        TruncatedNormalInitializer
    )
    variance_scaling_initializer: Optional[VarianceScalingInitializer] = message(
        VarianceScalingInitializer
    )
    random_normal_initializer: Optional[RandomNormalInitializer] = message(
        RandomNormalInitializer
    )
    glorot_normal_initializer: Optional[GlorotNormalInitializer] = message(
        GlorotNormalInitializer
    )
    glorot_uniform_initializer: Optional[GlorotUniformInitializer] = message(
        GlorotUniformInitializer
    )

    def which_oneof(self):
        return _which(
            self,
            [
                "truncated_normal_initializer",
                "variance_scaling_initializer",
                "random_normal_initializer",
                "glorot_normal_initializer",
                "glorot_uniform_initializer",
            ],
        )


@dataclass
class BatchNorm(Config):
    decay: float = scalar(float, 0.999)
    center: bool = scalar(bool, True)
    scale: bool = scalar(bool, False)
    epsilon: float = scalar(float, 0.001)
    train: bool = scalar(bool, True)


@dataclass
class Hyperparams(Config):
    op: str = enum("FC")
    regularizer: Optional[Regularizer] = message(Regularizer)
    initializer: Optional[Initializer] = message(Initializer)
    activation: str = enum("RELU")
    batch_norm: Optional[BatchNorm] = message(BatchNorm)
    regularize_depthwise: bool = scalar(bool, False)


# ---------------------------------------------------------------------------
# image_resizer.proto / preprocess.proto / post_process.proto
# ---------------------------------------------------------------------------


@dataclass
class DefaultResizer(Config):
    pass


@dataclass
class FixedShapeResizer(Config):
    height: int = scalar(int, 300)
    width: int = scalar(int, 300)


@dataclass
class KeepAspectRatioResizer(Config):
    min_dimension: int = scalar(int, 600)


@dataclass
class RandomScaleResizer(Config):
    max_dimension: List[int] = repeated(int)


@dataclass
class ImageResizer(Config):
    default_resizer: Optional[DefaultResizer] = message(DefaultResizer)
    fixed_shape_resizer: Optional[FixedShapeResizer] = message(FixedShapeResizer)
    keep_aspect_ratio_resizer: Optional[KeepAspectRatioResizer] = message(
        KeepAspectRatioResizer
    )
    random_scale_resizer: Optional[RandomScaleResizer] = message(RandomScaleResizer)

    def which_oneof(self):
        return _which(
            self,
            [
                "default_resizer",
                "fixed_shape_resizer",
                "keep_aspect_ratio_resizer",
                "random_scale_resizer",
            ],
        )


@dataclass
class Preprocess(Config):
    random_flip_left_right_prob: float = scalar(float, 0.0)
    random_crop_prob: float = scalar(float, 0.0)
    random_crop_min_scale: float = scalar(float, 0.8)
    random_brightness_prob: float = scalar(float, 0.0)
    random_brightness_max_delta: float = scalar(float, 0.2)
    random_contrast_prob: float = scalar(float, 0.0)
    random_contrast_lower: float = scalar(float, 0.8)
    random_contrast_upper: float = scalar(float, 1.2)
    random_hue_prob: float = scalar(float, 0.0)
    random_hue_max_delta: float = scalar(float, 0.18)
    random_saturation_prob: float = scalar(float, 0.0)
    random_saturation_lower: float = scalar(float, 0.8)
    random_saturation_upper: float = scalar(float, 1.2)
    # NON-REFERENCE EXTENSION. The reference's cap2det reader only runs
    # the flip-only v2 preprocess path (core/preprocess.py:56-78,
    # readers/cap2det_reader.py:91) and silently IGNORES the photometric
    # knobs above. This framework refuses photometric knobs on the
    # cap2det reader unless this opt-in is set — see the deviation table
    # in README.md.
    enable_photometric_augmentation: bool = scalar(bool, False)


@dataclass
class PostProcess(Config):
    score_thresh: float = scalar(float, 1e-6)
    iou_thresh: float = scalar(float, 0.5)
    max_size_per_class: int = scalar(int, 100)
    max_total_size: int = scalar(int, 300)


# ---------------------------------------------------------------------------
# reader.proto
# ---------------------------------------------------------------------------


@dataclass
class Cap2DetReader(Config):
    input_pattern: List[str] = repeated(str)
    interleave_cycle_length: int = scalar(int, 2)
    is_training: bool = scalar(bool, False)
    shuffle_buffer_size: int = scalar(int, 1000)
    map_num_parallel_calls: int = scalar(int, 1)
    prefetch_buffer_size: int = scalar(int, 200)
    batch_size: int = scalar(int, 32)
    decode_image: bool = scalar(bool, True)
    image_resizer: Optional[ImageResizer] = message(ImageResizer)
    preprocess_options: Optional[Preprocess] = message(Preprocess)
    max_num_proposals: int = scalar(int, 500)
    batch_resize_scale_value: List[float] = repeated(float)
    shard_indicator: str = scalar(str, "")


@dataclass
class Reader(Config):
    cap2det_reader: Optional[Cap2DetReader] = message(Cap2DetReader)

    def which_oneof(self):
        return _which(self, ["cap2det_reader"])


# ---------------------------------------------------------------------------
# frcnn.proto
# ---------------------------------------------------------------------------


@dataclass
class FasterRcnnFeatureExtractor(Config):
    type: str = scalar(str, "")
    first_stage_features_stride: int = scalar(int, 16)
    batch_norm_trainable: bool = scalar(bool, False)


@dataclass
class FRCNN(Config):
    feature_extractor: Optional[FasterRcnnFeatureExtractor] = message(
        FasterRcnnFeatureExtractor
    )
    inplace_batchnorm_update: bool = scalar(bool, False)
    initial_crop_size: int = scalar(int, 14)
    maxpool_kernel_size: int = scalar(int, 2)
    maxpool_stride: int = scalar(int, 2)
    dropout_keep_prob: float = scalar(float, 1.0)
    dropout_on_feature_map: bool = scalar(bool, True)
    checkpoint_path: str = scalar(str, "")


# ---------------------------------------------------------------------------
# label_extractor.proto
# ---------------------------------------------------------------------------


@dataclass
class GroundtruthExtractor(Config):
    label_file: str = scalar(str, "")


@dataclass
class ExactMatchExtractor(Config):
    label_file: str = scalar(str, "")


@dataclass
class ExtendMatchExtractor(Config):
    label_file: str = scalar(str, "")


@dataclass
class WordVectorMatchExtractor(Config):
    label_file: str = scalar(str, "")
    open_vocabulary_file: str = scalar(str, "")
    open_vocabulary_word_embedding_file: str = scalar(str, "")


@dataclass
class TextClassifierMatchExtractor(Config):
    label_file: str = scalar(str, "")
    open_vocabulary_file: str = scalar(str, "")
    open_vocabulary_word_embedding_file: str = scalar(str, "")
    text_classifier_checkpoint_file: str = scalar(str, "")
    hidden_units: int = scalar(int, 300)
    dropout_keep_proba: float = scalar(float, 1.0)
    regularizer: float = scalar(float, 1e-6)
    label_threshold: float = scalar(float, 0.5)


@dataclass
class LabelExtractor(Config):
    groundtruth_extractor: Optional[GroundtruthExtractor] = message(GroundtruthExtractor)
    exact_match_extractor: Optional[ExactMatchExtractor] = message(ExactMatchExtractor)
    extend_match_extractor: Optional[ExtendMatchExtractor] = message(ExtendMatchExtractor)
    word_vector_match_extractor: Optional[WordVectorMatchExtractor] = message(
        WordVectorMatchExtractor
    )
    text_classifier_match_extractor: Optional[TextClassifierMatchExtractor] = message(
        TextClassifierMatchExtractor
    )

    def which_oneof(self):
        return _which(
            self,
            [
                "groundtruth_extractor",
                "exact_match_extractor",
                "extend_match_extractor",
                "word_vector_match_extractor",
                "text_classifier_match_extractor",
            ],
        )


# ---------------------------------------------------------------------------
# cap2det_model.proto (Model extensions)
# ---------------------------------------------------------------------------


@dataclass
class Cap2DetModel(Config):
    midn_loss_weight: float = scalar(float, 1.0)
    oicr_loss_weight: float = scalar(float, 1.0)
    frcnn_options: Optional[FRCNN] = message(FRCNN)
    fc_hyperparams: Optional[Hyperparams] = message(Hyperparams)
    oicr_iterations: int = scalar(int, 0)
    oicr_iou_threshold: float = scalar(float, 0.5)
    midn_post_processor: Optional[PostProcess] = message(PostProcess)
    oicr_post_processor: Optional[PostProcess] = message(PostProcess)
    eval_min_dimension: List[int] = repeated(int)
    oicr_use_proba_r_given_c: bool = scalar(bool, True)
    label_extractor: Optional[LabelExtractor] = message(LabelExtractor)


@dataclass
class TextModel(Config):
    label_extractor: Optional[GroundtruthExtractor] = message(GroundtruthExtractor)
    text_classifier: Optional[TextClassifierMatchExtractor] = message(
        TextClassifierMatchExtractor
    )


@dataclass
class Model(Config):
    """Open extension point (model.proto): exactly one extension is set."""

    # Typed message fields so the non-extension spelling
    # `model { cap2det_model {...} }` is validated too (the raw-dict
    # assignment used to defer the failure to registry.build).
    cap2det_model: Optional[Cap2DetModel] = message(Cap2DetModel)
    text_model: Optional[TextModel] = message(TextModel)

    _EXTENSIONS = {
        "Cap2DetModel.ext": ("cap2det_model", Cap2DetModel),
        "TextModel.ext": ("text_model", TextModel),
    }

    def which_oneof(self):
        return _which(self, ["cap2det_model", "text_model"])


# ---------------------------------------------------------------------------
# pipeline.proto
# ---------------------------------------------------------------------------


@dataclass
class LearningRateDecay(Config):
    decay_steps: int = scalar(int, 999999999)
    decay_rate: float = scalar(float, 1.0)
    staircase: bool = scalar(bool, True)


@dataclass
class GradientMultiplier(Config):
    scope: str = scalar(str, "")
    multiplier: float = scalar(float, 0.0)


@dataclass
class TrainConfig(Config):
    max_steps: int = scalar(int, 0)
    optimizer: Optional[Optimizer] = message(Optimizer)
    learning_rate: float = scalar(float, 0.0)
    save_summary_steps: int = scalar(int, 2000)
    save_checkpoints_steps: int = scalar(int, 2000)
    keep_checkpoint_max: int = scalar(int, 5)
    log_step_count_steps: int = scalar(int, 2000)
    learning_rate_decay: Optional[LearningRateDecay] = message(LearningRateDecay)
    sync_replicas: bool = scalar(bool, False)
    moving_average_decay: float = scalar(float, 0.999)
    gradient_multiplier: List[GradientMultiplier] = repeated_message(GradientMultiplier)
    max_gradient_norm: float = scalar(float, 0.0)


@dataclass
class EvalConfig(Config):
    steps: int = scalar(int, 0)
    start_delay_secs: int = scalar(int, 60)
    throttle_secs: int = scalar(int, 120)


@dataclass
class Pipeline(Config):
    train_reader: Optional[Reader] = message(Reader)
    eval_reader: Optional[Reader] = message(Reader)
    model: Optional[Model] = message(Model)
    model_dir: str = scalar(str, "")
    train_config: Optional[TrainConfig] = message(TrainConfig)
    eval_config: Optional[EvalConfig] = message(EvalConfig)


def load_pipeline(path):
    """Loads a pipeline pbtxt file into a `Pipeline` config."""
    return Pipeline.from_dict(pbtxt.parse_file(path))


def loads_pipeline(text):
    return Pipeline.from_dict(pbtxt.parse(text))
