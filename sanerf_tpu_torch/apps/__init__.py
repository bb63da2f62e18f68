"""Applications of the port: the interactive segmentation frame."""
