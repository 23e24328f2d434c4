"""Draft proposers for speculative decoding (serving/engine.py).

PyTorch counterpart of ``repro/serving/spec_decode.py``.  Speculation is
draft-then-verify: a cheap proposer guesses up to ``k`` next tokens for a
running sequence, the engine verifies all of them in one multi-token device
step (``models.transformer.verify_chunk_batch``, the chunk step with logits
at every position) and rolls rejected tail tokens back by block-pool
truncation (``BlockAllocator.truncate``).

Correctness never depends on the draft: the acceptance rule samples every
position from the verified logits with the keys non-speculative decode
would have used, so a proposer decides how many tokens land per step, never
which.  ``propose`` touches neither the allocator nor the cache; it sees the
prompt and the accepted output so far.

* :class:`NgramProposer` -- prompt lookup: the most recent earlier
  occurrence of the context's n-gram suffix proposes the tokens that
  followed it.  Pure numpy on the host, the reference's arithmetic.
* :class:`DraftModelProposer` -- a draft model proposes ``k`` greedy
  tokens: a whole-context ``prefill`` into a fresh dense cache, then
  ``k - 1`` ``decode_step`` s, on the draft parameters' device.
"""

from __future__ import annotations

from typing import List, Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class DraftProposer(Protocol):
    """Anything with ``propose(prompt, output, k) -> list[int]``.

    ``prompt`` is the request's token ids (np.ndarray), ``output`` the
    accepted generated tokens so far (never speculative ones: rollback
    happens before the proposer sees the sequence again).  Return at most
    ``k`` draft ids; fewer, or none, is legal and shrinks the verify step
    toward a plain decode."""

    def propose(self, prompt: np.ndarray, output: List[int],
                k: int) -> List[int]:
        ...


class NgramProposer:
    """Prompt-lookup / n-gram self-speculation: match the longest suffix of
    the context (prompt + output, ``max_n`` down to ``min_n`` tokens)
    against its most recent earlier occurrence and propose what followed
    it.  No model and no state."""

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1,
                 max_context: int = 1024):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n
        self.max_context = max_context

    def propose(self, prompt: np.ndarray, output: List[int],
                k: int) -> List[int]:
        if k <= 0:
            return []
        ctx = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(output or [], np.int64)])
        if len(ctx) > self.max_context:
            ctx = ctx[-self.max_context:]
        n_ctx = len(ctx)
        for n in range(min(self.max_n, n_ctx - 1), self.min_n - 1, -1):
            suffix = ctx[n_ctx - n:]
            # the most recent earlier occurrence, ending before the suffix
            # starts, so that its continuation is genuinely earlier context
            for i in range(n_ctx - n - 1, -1, -1):
                if np.array_equal(ctx[i:i + n], suffix):
                    cont = ctx[i + n:i + n + k]
                    if len(cont):
                        return [int(t) for t in cont]
                    break
        return []


class DraftModelProposer:
    """Greedy ``k``-token proposals from a draft model (a
    :class:`~repro_torch.models.model.Model` and its parameters).  Each
    call prefills the whole context into a fresh dense cache of
    ``len(context) + k`` positions and rolls greedy decode steps, on the
    device the parameters live on; only the argmax of each step comes back
    to the host.  The draft model's vocabulary must be the target's (the
    acceptance rule compares ids).  Stateless across calls, so preemption,
    rollback and fanout need no proposer bookkeeping."""

    name = "draft_model"

    def __init__(self, model, params, max_seq: int = 2048):
        self.model = model
        self.params = params
        self.max_seq = max_seq

    def propose(self, prompt: np.ndarray, output: List[int],
                k: int) -> List[int]:
        ctx = np.concatenate([np.asarray(prompt, np.int32),
                              np.asarray(output or [], np.int32)])
        k = min(k, self.max_seq - len(ctx))
        if k <= 0:
            return []
        dev = self.params["final_norm"]["gamma"].device
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(ctx, device=dev)[None]},
            max_seq=len(ctx) + k)
        drafts: List[int] = []
        for _ in range(k):
            tok = torch.argmax(logits[0])
            drafts.append(int(tok))
            if len(drafts) == k:
                break
            logits, cache = self.model.decode_step(self.params, cache,
                                                   tok.reshape(1))
        return drafts


def build_proposer(kind: str, **kw) -> DraftProposer:
    """``"ngram"`` (the default) or ``"draft_model"`` (needs ``model=`` and
    ``params=``)."""
    if kind == "ngram":
        return NgramProposer(**kw)
    if kind == "draft_model":
        return DraftModelProposer(**kw)
    raise ValueError(f"unknown draft proposer {kind!r} "
                     "(expected 'ngram' or 'draft_model')")
