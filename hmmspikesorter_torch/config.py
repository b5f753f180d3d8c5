"""Configuration (copy of the JAX package's config.py: the model, train,
decode and mesh sections): an explicitly passed kwarg wins over the config,
which wins over the built-in (reference) default.

`config` arguments in this package are duck-typed: any object with
`.model`, `.train`, `.decode` or `.mesh` sections works, the JAX package's
`Config` included. `TrainConfig.fb_mode` takes the port's engine names
(train/em.py): "overlap_cuda" in place of the JAX "overlap_pallas".
"""

from __future__ import annotations

import dataclasses


class _Unset:
    """Sentinel distinguishing 'kwarg not passed' from a passed None."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "UNSET"

    def __bool__(self):
        return False


UNSET = _Unset()


def pick(explicit, cfg_value, default):
    """explicit kwarg > config field > built-in default."""
    if explicit is not UNSET:
        return explicit
    if cfg_value is not UNSET and cfg_value is not None:
        return cfg_value
    return default


@dataclasses.dataclass
class ModelConfig:
    """State-space topology (reference src/baumwelch.jl:311, types.jl:65)."""

    n_neurons: int = 3
    K: int = 60
    allow_overlaps: bool = False     # decode-time; training is non-overlap


@dataclasses.dataclass
class TrainConfig:
    """EM training schedule and surgery thresholds (baumwelch.jl:311-354)."""

    nsteps: int | None = None        # None -> entry-point default (8 for
    #                                  train_model, baumwelch.jl:311; 10
    #                                  for fit_template_model)
    p0: float | None = None          # None -> 2^(-3K/2) (baumwelch.jl:311)
    condense_alpha: float = 0.05     # merge chi^2 level (baumwelch.jl:340)
    sparse_lp0: float = -70.0        # onset-logp cutoff (baumwelch.jl:344)
    small_alpha: float = 0.05        # energy-test level (baumwelch.jl:347)
    fb_mode: str | None = None       # None -> train.em.choose_fb_mode:
    #                                  ring on the CPU, overlap_cuda on
    #                                  CUDA (plain engines for signals
    #                                  shorter than two kernel windows)


@dataclasses.dataclass
class DecodeConfig:
    """Decode protocol: reference-sequential or parallel overlap-save."""

    engine: str = "reference"        # "reference" | "fast"
    chunksize: int = 100_000         # reference src/hmmsort.jl:90
    L: int = 8192                    # overlap-save core block
    H: int | None = None             # halo; None -> max(4K, 64)
    streaming: bool | None = None    # None = auto (recordings past
    #                                  MAX_ONESHOT_BLOCKS stream); True /
    #                                  False force the block-batch loop
    #                                  or the one-shot program
    blocks_per_call: int = 256
    prefetch: int = 2                # streaming double-buffer depth
    repair: bool = True              # widen-and-re-decode flagged seams
    block_engine: str = "auto"   # "ring" | "cuda" | "auto"
    transfer: str = "dense"          # "dense" | "events" (sparse onset
    #                                  grid + exact host reconstruction —
    #                                  core/events.py; wins when the
    #                                  host<->device label transfer
    #                                  dominates, e.g. tunneled backends)
    channels: object = 1             # 1 (reference contract) | "all"
    multichannel: bool = False       # joint multi-channel decode (all
    #                                  spikeForms channels; beyond reference)
    max_templates: int = 4           # CLI bail threshold (hmmsort.jl:50)
    confidence: bool = False         # add per-spike posterior confidence
    #                                  to the CLI output (core/posterior)
    qc: bool = False                 # per-unit quality-control struct in
    #                                  the CLI output (core/qc.py)
    adaptive: bool = False           # drift-adaptive decode: online-EM
    #                                  template tracking + per-chunk
    #                                  decode (train/adaptive.py)
    adapt_chunk: int = 32768         # tracking chunk / decode window
    forget: float = 0.3              # online-EM forgetting factor (0, 1]


@dataclasses.dataclass
class MeshConfig:
    """Mesh layout of the sharded paths (parallel/runner.make_mesh): shards
    of a LocalMesh in one process, or ranks of a DistMesh."""

    time_shards: int | None = None     # None -> infer from the shard count
    channel_shards: int | None = None
    axes: tuple = ("channel", "time")


@dataclasses.dataclass
class Config:
    """The full configuration (the JAX `Config`'s sections)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def _section(config: Config | None, name: str):
    """Returns an attribute-getter over one section that yields UNSET when
    no config was provided (so `pick` falls through to the default)."""
    sec = getattr(config, name, None) if config is not None else None

    def get(field):
        return getattr(sec, field) if sec is not None else UNSET

    return get
