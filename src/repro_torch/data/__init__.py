from repro_torch.data.pipeline import (DeterministicLoader, LoaderConfig,
                                       TokenDataset, synthetic_corpus,
                                       write_token_shards)

__all__ = ["DeterministicLoader", "LoaderConfig", "TokenDataset",
           "synthetic_corpus", "write_token_shards"]
