"""Serving example on the PyTorch port: batched decode with the
RARO-tiered KV cache (the paper's technique as a serving feature,
DESIGN.md §2B).

Decodes a batch of sequences through repro_torch.launch.serve (the
tiered_decode_partial and quantize_pages CUDA kernels on the card, their
plain PyTorch versions on the CPU), RARO promoting hot pages to bf16 and
demoting cold ones to int4, then compares against static all-int4. Runs on
CUDA unless --device names another device:

  PYTHONPATH=src python examples/torch_serve_tiered.py --steps 64 --batch 4 [--device cpu]
"""

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
