"""The plain references: plain PyTorch f32 (f64 for Algorithm 1), importing nothing of the program."""
