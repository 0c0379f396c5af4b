"""Default constants for bronko-tpu.

Mirrors the reference CLI surface so results and flag defaults are drop-in
compatible (reference: src/consts.rs:1-21).
"""

BRONKO_TPU_VERSION = "0.1.0"

MIN_KMER_SIZE = 15
DEFAULT_KMER_SIZE = 21
MAX_KMER_SIZE = 31

# minimum number of times a k-mer must occur in the reads to be mapped
MIN_KMER_COUNT = 3
# count cap applied by the read k-mer counter (reference: call.rs:1173, KMC -cs)
KMER_COUNT_CAP = 1_000_000

DEFAULT_MIN_AF = 0.03
DEFAULT_NO_FILTER_ENDS = False
DEFAULT_NO_STRAND_FILTER = False
DEFAULT_NO_STRAND_BALANCE_FILTER = False
DEFAULT_STRAND_BALANCE_RATIO = 0.1
DEFAULT_N_KMERS_PER_STRAND = 2
DEFAULT_MAX_STRAND_ODDS = 6.0
DEFAULT_NOISE_MULTIPLIER = 1.5
DEFAULT_TSV_PILEUP = False
DEFAULT_ALIGNMENT = False
DEFAULT_KEEP_KMER_INFO = False
DEFAULT_N_FIXED = 2
DEFAULT_USE_FULL_KMER = False
DEFAULT_MIN_DEPTH = MIN_KMER_COUNT * 100
DEFAULT_INDEX_OUTPUT = "bronko"
DEFAULT_OUT_FOLDER = "bronko_output"

# Baseline-noise estimator parameters (reference: call.rs:801-804)
NOISE_WINDOW_SIZE = 100
NOISE_ALPHA = 0.001
NOISE_MAX_TABLE_LEN = NOISE_WINDOW_SIZE // 10
