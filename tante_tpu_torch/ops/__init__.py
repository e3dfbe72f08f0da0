"""Device gate, initializers, activations, patch convs and the fused-block
kernels of the port."""
