"""The paper's contribution: democratic embeddings, source coding, algorithms."""
from repro_torch.core.frames import (DenseFrame, HadamardFrame, haar_frame,
                                     hadamard_frame, subgaussian_frame,
                                     make_frame, next_pow2)
from repro_torch.core.embeddings import (EmbeddingSpec, democratic,
                                         near_democratic,
                                         kashin_constant_upper)
from repro_torch.core.coding import Codec, CodecConfig, Payload

__all__ = ["DenseFrame", "HadamardFrame", "haar_frame", "hadamard_frame",
           "subgaussian_frame", "make_frame", "next_pow2", "EmbeddingSpec",
           "democratic", "near_democratic", "kashin_constant_upper", "Codec",
           "CodecConfig", "Payload"]
