from repro_torch.data.curation import CurationPipeline, synthetic_corpus

__all__ = ["CurationPipeline", "synthetic_corpus"]
