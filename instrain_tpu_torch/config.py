"""
Typed configuration for instrain_tpu_torch (counterpart of
instrain_tpu/config.py; same defaults, reference:
inStrain/argumentParser.py:55-398).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ReadFilterConfig:
    """Read-pair filtering (reference: argumentParser.py:74-95)."""

    min_read_ani: float = 0.95        # PID must be > this (strictly)
    min_mapq: int = -1                # pair max mapq must be > this
    max_insert_relative: float = 3.0  # max insert = this * median insert
    min_insert: int = 50              # insert must be > this
    pairing_filter: str = "paired_only"  # paired_only|non_discordant|all_reads
    priority_reads: Optional[str] = None
    maximum_reads: Optional[int] = None


@dataclass
class VariantConfig:
    """SNV calling (reference: argumentParser.py:104-112)."""

    min_cov: int = 5
    min_freq: float = 0.05
    fdr: float = 1e-6
    # "analytic" = exact binomial survival thresholds, or a path to an
    # inStrain-format NullModel.txt (kernels/nullmodel.py)
    null_model: str = "analytic"
    null_model_error_rate: float = 0.001
    null_model_max_coverage: int = 10000


@dataclass
class ProfileConfig:
    """`profile` operation (reference: argumentParser.py:134-180)."""

    output: str = "instrain_tpu_torch"
    use_full_fasta_header: bool = False
    force_compress: bool = False
    processes: int = 6                 # host-side decode threads
    database_mode: bool = False
    min_scaffold_reads: int = 1
    min_genome_coverage: float = 0.0
    min_snp: int = 20                  # min reads linking two SNVs for LD
    store_everything: bool = False
    scaffolds_to_profile: Optional[str] = None
    rarefied_coverage: int = 50
    window_length: int = 10000
    skip_genome_wide: bool = False
    skip_plot_generation: bool = False
    skip_mm_profiling: bool = False
    mm_level: bool = False
    gene_file: Optional[str] = None
    stb: List[str] = field(default_factory=list)
    detailed_mapping_info: bool = False
    debug: bool = False

    filter: ReadFilterConfig = field(default_factory=ReadFilterConfig)
    variant: VariantConfig = field(default_factory=VariantConfig)

    # execution (no reference equivalent)
    engine: str = "auto"               # auto|dense|hybrid|batch
    seed: int = 42                     # key for the rarefied draws
    # shard the profile kernels over N devices (0 or 1: one device):
    # hybrid splits each scaffold's positions, batch its chunks
    # (parallel/mesh.py)
    mesh_devices: int = 0
    # several processes (--distributed): "primary" — only process 0
    # writes the profile directory; "all" — every process writes a whole,
    # identical one
    distributed_store: str = "primary"
    # where the kernels run: "cuda" (a GPU is required; no fallback) or
    # "cpu" (the kernels' plain PyTorch versions)
    device: str = "cuda"

    def apply_database_mode(self) -> "ProfileConfig":
        """reference: controller.py:211-214."""
        if self.database_mode:
            self.filter.min_read_ani = 0.92
            self.skip_mm_profiling = True
            self.min_genome_coverage = 1
        return self


@dataclass
class CompareConfig:
    """`compare` operation (reference: argumentParser.py:183-239)."""

    output: str = "instrainComparer"
    processes: int = 6
    stb: List[str] = field(default_factory=list)
    min_cov: int = 5
    min_freq: float = 0.05
    fdr: float = 1e-6
    null_model: str = "analytic"
    database_mode: bool = False
    breadth: float = 0.5
    scaffolds: Optional[str] = None
    genome: Optional[str] = None
    store_coverage_overlap: bool = False
    store_mismatch_locations: bool = False
    include_self_comparisons: bool = False
    skip_plot_generation: bool = False
    group_length: int = 10_000_000
    force_compress: bool = False
    ani_threshold: float = 0.99999
    coverage_treshold: float = 0.1    # (sic) reference spelling kept for CLI parity
    clusterAlg: str = "average"
    bams: List[str] = field(default_factory=list)
    skip_popANI: bool = False
    # overlap-count engine: auto | host | device (compare/pipeline.py:
    # use_device_overlap; device = the overlap_counts kernel on `device`)
    engine: str = "auto"
    device: str = "cuda"
