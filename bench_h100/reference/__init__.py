"""The benchmark's plain float32 reference: TV-L1, Farneback, ResNet-18
and the two-stream pipeline in plain PyTorch, importing nothing of the
program."""
