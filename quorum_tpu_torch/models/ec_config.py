"""Error-correction configuration (counterpart of
quorum_tpu/models/ec_config.py): field names and defaults mirror the
reference CLI (src/error_correct_reads_cmdline.yaggo); window/error of 0
fall back to k and k/2 (error_correct_reads.cc:197-216)."""

from __future__ import annotations

import dataclasses

# numeric_limits<char>::max(): no base is quality-protected
DEFAULT_QUAL_CUTOFF = 127


@dataclasses.dataclass(frozen=True)
class ECConfig:
    k: int
    skip: int = 1
    good: int = 2
    anchor_count: int = 3
    min_count: int = 1
    # no default: the -p value or the database-computed cutoff
    # (models/error_correct.resolve_cutoff)
    cutoff: int = dataclasses.field(default=None)  # type: ignore[assignment]
    qual_cutoff: int = DEFAULT_QUAL_CUTOFF  # ASCII code
    window: int = 10
    error: int = 3
    homo_trim: int | None = None  # --homo-trim: trim a 3' homopolymer
    trim_contaminant: bool = False  # --trim-contaminant: trim, not skip
    no_discard: bool = False
    collision_prob: float = 0.01 / 3.0
    poisson_threshold: float = 1e-6

    def __post_init__(self):
        if self.cutoff is None:
            raise TypeError(
                "ECConfig.cutoff has no default: pass the -p value or the "
                "database-computed cutoff (models/error_correct."
                "resolve_cutoff)")

    @property
    def effective_window(self) -> int:
        return self.window if self.window else self.k

    @property
    def effective_error(self) -> int:
        return self.error if self.error else self.k // 2

    @property
    def do_homo_trim(self) -> bool:
        return self.homo_trim is not None


def jax_repr(cfg: ECConfig) -> str:
    """repr() of the JAX package's ECConfig of the same settings: the
    stage-2 journal's resume identity (io/checkpoint.Stage2Journal),
    so each package resumes the other's journal. The JAX class has one
    more field, poisson_dtype, at its default "float64" on every path
    the CLIs run."""
    return repr(cfg)[:-1] + ", poisson_dtype='float64')"


ERROR_CONTAMINANT = "Contaminated read"
ERROR_NO_STARTING_MER = "No high quality mer"
ERROR_HOMOPOLYMER = "Entire read is an homopolymer"
