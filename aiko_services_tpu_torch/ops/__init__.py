# Tensor ops of the port: attention (and its CUDA kernels), the audio
# frontend, the batching scheduler, and the kernels' build and loader.
