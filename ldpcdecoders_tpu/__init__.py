"""ldpcdecoders_tpu — a batched LDPC syndrome-decoding framework.

Brand-new JAX/XLA/Pallas implementation with the capabilities of
QuantumSavory/LDPCDecoders.jl (reference surveyed in SURVEY.md): Gallager
code construction, Tanner-graph compilation, and batched sum-product BP,
BP+OSD, iterative bit-flip, and BP-OTS decoders, designed for SPMD
execution over GPU device meshes.
"""

from .codes import (
    parity_check_matrix,
    save_pcm,
    load_pcm,
    TannerGraph,
    toric_code_x,
    toric_code_z,
    surface_code_x,
    surface_code_z,
    repetition_code,
    cycle_matrix,
    hamming_code,
    hypergraph_product,
    hypergraph_product_edges,
    qc_lift,
    qc_lift_edges,
    random_qc_base_matrix,
    save_base_matrix,
    load_base_matrix,
    bb_poly_matrix,
    bivariate_bicycle_code,
    css_code_k,
    named_bicycle_code,
    BICYCLE_CODES,
    spacetime_pcm,
    spacetime_prior,
    detectors_of,
    StabilizerCircuit,
    css_memory_circuit,
    circuit_dem,
    dem_text,
    sample_circuit,
)
from .models import (
    Decoder,
    DecodeStats,
    decode,
    batchdecode,
    BeliefPropagationDecoder,
    BeliefPropagationOSDDecoder,
    BitFlipDecoder,
    BPOTSDecoder,
    MinSumDecoder,
    QuantizedMinSumDecoder,
    LayeredMinSumDecoder,
    BucketedDecoder,
    CSSDecoder,
    QCMinSumDecoder,
    ErasurePeelingDecoder,
    MixedChannelDecoder,
    NeuralMinSumDecoder,
    SpaceTimeDecoder,
    SlidingWindowDecoder,
    DetectorGraphDecoder,
    EnsembleDecoder,
    StagedDemDecoder,
    WindowedDemDecoder,
    load_dem,
    decode_soft,
)
from . import parallel
from .config import DecoderConfig
from .cache import enable_compilation_cache

__version__ = "0.1.0"
