"""Data feeds for training and eval.

``synthetic``: an on-device linear-motion triplet generator, the stand-in
for a Vimeo-90K loader where no dataset can be downloaded.
"""

from rrin_tpu_torch.data.synthetic import synthetic_triplet_batch

__all__ = ["synthetic_triplet_batch"]
