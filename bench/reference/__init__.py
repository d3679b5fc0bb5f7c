"""The plain reference: the configuration's model, loss and optimizer in
plain PyTorch, in float32 with TF32 off, with no kernels, no cache and no
batching tricks.  It imports nothing of the program; it takes the weights
and the inputs the benchmark made and works out everything else again."""
