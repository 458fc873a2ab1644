# FEMU-analogue vectorized flash-storage simulator (DESIGN.md §2A), PyTorch port.
