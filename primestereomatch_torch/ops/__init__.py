"""Plain PyTorch ops of the STEREO_GIF path; each keeps the JAX package's
module name and term order."""
