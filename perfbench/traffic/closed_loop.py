"""Closed-loop multi-turn chat: each client sends its next turn as soon as
its last one is answered (``chat``)."""

from __future__ import annotations

from typing import List

import numpy as np

from perfbench.core.traffic import Item, grid, rng_for

#: the serving cell drives it from the serve loop's step hook
HARNESS = "serve_closed"


class Sessions:
    """``clients`` sessions with no think time.  Every session starts with
    one system prompt that all share; each turn sends the history plus a
    new user turn, and the history then gains the served answer.  A turn
    that would take the context past ``max_context`` starts the session
    over.

    What a turn asks is fixed by (seed, client, turn), not by the order in
    which turns come: the k-th turns of all clients together get the
    ``clients`` mid-quantiles of the user and answer sizes, dealt to the
    clients in an order drawn from (seed, k).  So every seed gives each
    round of turns the same work, and two runs of one seed send the same
    turns however the program's timing interleaves them.  With
    ``warm_start`` the sessions begin at depths on a grid over the context
    (history of drawn tokens), so the window sees sessions of every age
    from its first step."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = int(seed)
        self.clients = int(mix["clients"])
        rng = rng_for(seed, 2)
        self.system = rng.integers(0, vocab, size=int(
            mix["system_tokens"]), dtype=np.int64)
        self.max_context = int(mix["max_context"])
        self._rounds: List[tuple] = []
        self._turn = [0] * self.clients
        self._next_index = 0
        depth = grid({"dist": "uniform", "low": 0,
                      "high": self.max_context}, self.clients, rng)
        self.history: List[np.ndarray] = []
        for c in range(self.clients):
            h = self.system
            extra = int(depth[c]) - len(h)
            if mix.get("warm_start", False) and extra > 0:
                h = np.concatenate([h, rng.integers(
                    0, vocab, size=extra, dtype=np.int64)])
            self.history.append(h)

    def sizes(self, client: int, turn: int):
        """(user tokens, answer tokens) of ``client``'s turn ``turn``."""
        while len(self._rounds) <= turn:
            rng = rng_for(self.seed, 2, 1, len(self._rounds))
            self._rounds.append((grid(self.mix["user_tokens"],
                                      self.clients, rng),
                                 grid(self.mix["answer_tokens"],
                                      self.clients, rng)))
        users, answers = self._rounds[turn]
        return int(users[client]), int(answers[client])

    def next_turn(self, client: int) -> Item:
        turn = self._turn[client]
        self._turn[client] += 1
        u, a = self.sizes(client, turn)
        h = self.history[client]
        if len(h) + u + a > self.max_context:
            h = self.system
        user = rng_for(self.seed, 2, 2, client, turn).integers(
            0, self.vocab, size=u, dtype=np.int64)
        prompt = np.concatenate([h, user]).astype(np.int32)
        self.history[client] = prompt
        self._next_index += 1
        return Item(index=self._next_index, due_s=0.0, prompt=prompt,
                    max_new_tokens=a, measured=True)

    def answered(self, client: int, served: List[int]) -> None:
        self.history[client] = np.concatenate(
            [self.history[client], np.asarray(served, np.int64)])
