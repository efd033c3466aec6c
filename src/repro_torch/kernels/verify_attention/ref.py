"""Plain PyTorch version of the verify attention (K3).

Verify attention computes the same function as the paged chunk
attention (K1): each lane carries its committed token and k drafts at
positions base..base+k, and query t attends causally to the kv
positions <= base + t on resident pages; a row that sees no valid key
outputs zeros.  Only the kernels' page-visit order differs.  So the
plain version is K1's, under the name of the JAX package's
``kernels/verify_attention/ref.py::verify_attention_ref``.  The CPU
tests run it, and ``chip_smoke.py`` holds the CUDA kernel
(``csrc/verify_attention.cu``) against it on the card.
"""

from __future__ import annotations

from ..paged_attention.ref import paged_attention_chunk_ref

#: q [B, T, H, hd]; k/v_pages [P, psz, KH, hd]; page_table int32
#: [B, maxp] (< 0 dead); base_lens int32 [B], the lengths BEFORE the
#: verify window -> [B, T, H, hd] in q's dtype, float32 inside.
verify_attention_ref = paged_attention_chunk_ref
