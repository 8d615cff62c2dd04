from repro_torch.data.pipeline import (DeterministicLoader, LoaderConfig,
                                       PrefetchLoader, TokenDataset,
                                       pack_documents, synthetic_corpus,
                                       write_token_shards)

__all__ = ["DeterministicLoader", "LoaderConfig", "PrefetchLoader",
           "TokenDataset", "pack_documents", "synthetic_corpus",
           "write_token_shards"]
