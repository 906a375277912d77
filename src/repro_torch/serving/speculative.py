"""Base-as-draft speculative decoding (port of
``repro.serving.speculative``).

The base model is resident next to every variant (bank slot 0 = base), so
it is a free draft model, and per-axis 1-bit deltas keep each variant
close to it.  One round per lane:

  draft   k greedy ``decode_step``s on the BASE weights with overlay None
          (the plain ``x @ w.T`` path: no delta kernel);
  verify  ONE banked ``verify_step`` over [pending, d_1..d_k] (T = k+1
          teacher-forced tokens at per-row positions over the live cache)
          through the lane's bank slot: the banked delta GEMM on
          B·(k+1) rows;
  accept  the longest prefix where draft == the variant's greedy token,
          plus the variant's own next token (``n_acc`` matches,
          ``n_acc + 1`` chain tokens), so the emitted stream is the
          variant's greedy chain whatever k and the acceptance;
  rewind  the cache retreats to the state after exactly ``n_acc + 1``
          tokens (``Model.verify_rewind``).

Why the emitted tokens are the variant's: verify logits[:, j] condition on
[pending, d_1..d_j].  For j < n_acc every d_i in that prefix equals the
variant's greedy token, so argmax(logits[:, j]) is the variant's own next
token; at the first mismatch the variant's correction is taken and the
rest is dropped with its cache writes.

The round runs eagerly, one function per k: the engine pays one host sync
per round for up to k+1 tokens a lane.

On a mesh (``serving/engine``) a round works on the rank's lanes and
blocks: the drafts run the base with overlay None, so each product is a
plain per-rank product, with its fp32 psum where the in dim is sharded;
the verify runs the banked kernel per rank on the rank's lanes' slot ids;
``verify`` and the accept/rewind act on the rank's rows alone.  The
engine then all-gathers (ver, n_acc, next_tok) over the lanes' axes, so
every rank appends the same tokens and its :class:`AcceptanceTracker`
sees the same counts: the ranks pick the same k each round and so make
the same collectives.  The caches of the attention
families are written in place (the JAX functions return new ones), so
the draft works on a shallow copy of the cache dict: its ``pos`` stays
the live one, and its K/V writes at pos..pos+k-1 go into the live
tensors, where the verify pass overwrites pos..pos+k before anything
reads them.
"""
from __future__ import annotations

import torch


def default_k_ladder(draft_k: int) -> list:
    """Draft lengths the adaptive controller may pick: powers of two up to
    ``draft_k`` plus ``draft_k`` itself."""
    if draft_k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    ladder = {1 << i for i in range(draft_k.bit_length())
              if (1 << i) <= draft_k}
    ladder.add(draft_k)
    return sorted(ladder)


def draft(model, params, token: torch.Tensor, cache, k: int
          ) -> torch.Tensor:
    """k greedy decode steps of the base (overlay None) from ``token``
    (B,) -> drafts (B, k) int32.  The caller's cache dict is left as it
    was (``pos`` included); see the module docstring for its K/V."""
    tok, c, out = token, dict(cache), []
    for _ in range(k):
        logits, c = model.decode_step(params, tok, c)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)


def verify(model, params, bank, vidx, token: torch.Tensor,
           drafts: torch.Tensor, cache) -> tuple:
    """The banked verify of [token, drafts] and the accept/rewind ->
    (ver (B, k+1) int32, n_acc (B,) int32, next_tok (B,) int32, cache)."""
    k = drafts.shape[1]
    seq = torch.cat([token[:, None], drafts], dim=1)
    logits, rewind_state = model.verify_step(params, seq, cache,
                                             overlay=bank, variant_idx=vidx)
    ver = torch.argmax(logits, dim=-1).to(torch.int32)       # (B, k+1)
    match = (drafts == ver[:, :k]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    next_tok = torch.gather(ver, 1, n_acc[:, None].to(torch.int64))[:, 0]
    return ver, n_acc, next_tok, model.verify_rewind(rewind_state,
                                                     n_acc + 1)


def make_round_fn(model, k: int):
    """The speculative round for draft length ``k``:
    ``spec_round(base_params, bank, vidx, pending_token, cache)`` ->

      ver      (B, k+1) int32  the variant's greedy tokens: ver[:, j]
               follows the teacher-forced prefix [pending, d_1..d_j]
      n_acc    (B,)     int32  accepted drafts in [0, k]
      next_tok (B,)     int32  the next pending token, ver[b, n_acc[b]]
      cache                    rewound to pos + n_acc + 1
    """
    def spec_round(params, bank, vidx, token, cache):
        drafts = draft(model, params, token, cache, k)
        return verify(model, params, bank, vidx, token, drafts, cache)

    return spec_round


class AcceptanceTracker:
    """Engine-wide adaptive draft length and acceptance counts.

    Keeps an EMA of each round's acceptance fraction (accepted / offered
    drafts over active lanes) and walks ``current_k`` along the ladder:
    down under persistent low acceptance, up under persistent near-full
    acceptance, at most once every ``cooldown`` rounds."""

    def __init__(self, draft_k: int, *, ema_decay: float = 0.7,
                 low: float = 0.4, high: float = 0.85, cooldown: int = 4,
                 adaptive: bool = True):
        self.ladder = default_k_ladder(draft_k)
        self.current_k = draft_k
        self.ema = 1.0          # optimistic start: base and variant agree
        self.ema_decay = ema_decay
        self.low = low
        self.high = high
        self.cooldown = cooldown
        self.adaptive = adaptive
        self.rounds = 0
        self.drafted = 0
        self.accepted = 0
        self._since_adjust = 0

    def observe(self, k: int, accepted: int, lanes: int) -> None:
        """One round: ``lanes`` active lanes were offered ``k`` drafts
        each and accepted ``accepted`` in total."""
        self.rounds += 1
        if lanes <= 0:
            return
        self.drafted += k * lanes
        self.accepted += accepted
        frac = accepted / float(k * lanes)
        self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * frac
        self._since_adjust += 1
        if not self.adaptive or self._since_adjust < self.cooldown:
            return
        i = self.ladder.index(self.current_k)
        if self.ema < self.low and i > 0:
            self.current_k = self.ladder[i - 1]
            self._since_adjust = 0
        elif self.ema > self.high and i < len(self.ladder) - 1:
            self.current_k = self.ladder[i + 1]
            self._since_adjust = 0

    @property
    def acceptance(self) -> float:
        """Lifetime acceptance rate (accepted / drafted)."""
        return self.accepted / self.drafted if self.drafted else 0.0

    def snapshot(self) -> dict:
        return {"current_k": self.current_k, "ladder": list(self.ladder),
                "acceptance_ema": self.ema, "acceptance": self.acceptance,
                "rounds": self.rounds, "drafted": self.drafted,
                "accepted": self.accepted}
