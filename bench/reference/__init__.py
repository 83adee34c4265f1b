"""Plain f32 PyTorch references of the benchmark's configurations, one
module a family, and the reference training step. They import nothing of
the program: no kernel, no cache, no batching, autograd for the gradients."""
