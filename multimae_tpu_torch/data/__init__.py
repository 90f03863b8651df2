"""Data pipeline: image files, folder datasets, pretraining augmentations, the loader."""
