"""Tokenization: HF fast tokenizers when a local tokenizer.json exists,
deterministic hash tokenizer otherwise (air-gapped fallback). The
`tokenizers` package is needed only for a tokenizer.json: without it,
`HFTokenizer` (which `make_tokenizer` picks) refuses the file by name
rather than fall back to the hash tokenizer, whose ids are other ids.

Port of `rag_inference_pipeline_tpu/models/tokenizer.py`; `encode_batch`
and `encode_pair_batch` give the same ids, masks and token types as the JAX
package's tokenizers.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Optional, Sequence

import numpy as np

_WORD_RE = re.compile(r"\w+|[^\w\s]")


class HashTokenizer:
    """Deterministic word-hash tokenizer with BERT-style special tokens."""

    def __init__(
        self,
        vocab_size: int = 30522,
        cls_id: int = 101,
        sep_id: int = 102,
        pad_id: int = 0,
        eos_id: Optional[int] = None,
        add_special: bool = True,
        eos_token: Optional[str] = None,
    ) -> None:
        self.vocab_size = vocab_size
        self.cls_id = cls_id
        self.sep_id = sep_id
        self.pad_id = pad_id
        self.eos_id = eos_id if eos_id is not None else sep_id
        self.eos_token = eos_token
        self.add_special = add_special
        self._reserved = {cls_id, sep_id, pad_id, self.eos_id}

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.blake2s(w.lower().encode()).digest()[:4], "little")
        tid = 1000 + h % (self.vocab_size - 1000)
        while tid in self._reserved:
            tid += 1
        return tid

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        ids = [self._word_id(w) for w in _WORD_RE.findall(text)]
        if self.add_special:
            ids = [self.cls_id] + ids[: max_len - 2] + [self.sep_id]
        else:
            ids = ids[:max_len]
        out = np.full(max_len, self.pad_id, np.int32)
        mask = np.zeros(max_len, np.int32)
        out[: len(ids)] = ids
        mask[: len(ids)] = 1
        return out, mask

    def encode_batch(
        self, texts: Sequence[str], max_len: int
    ) -> tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(t, max_len) for t in texts]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def encode_pair_batch(
        self, pairs: Sequence[tuple[str, str]], max_len: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(query, doc) pairs -> ids/mask/token types (cross-encoder input):
        [CLS] query [SEP] doc [SEP], the query cut to half the budget."""
        ids = np.full((len(pairs), max_len), self.pad_id, np.int32)
        mask = np.zeros((len(pairs), max_len), np.int32)
        tt = np.zeros((len(pairs), max_len), np.int32)
        for r, (a, b) in enumerate(pairs):
            wa = [self._word_id(w) for w in _WORD_RE.findall(a)]
            wb = [self._word_id(w) for w in _WORD_RE.findall(b)]
            budget = max_len - 3
            wa = wa[: budget // 2]
            wb = wb[: budget - len(wa)]
            seq = [self.cls_id] + wa + [self.sep_id] + wb + [self.sep_id]
            n = len(seq)
            ids[r, :n] = seq
            mask[r, :n] = 1
            tt[r, len(wa) + 2 : n] = 1
        return ids, mask, tt

    def decode(self, ids: Sequence[int]) -> str:
        """Hash ids aren't invertible; emit placeholder words (offline mode)."""
        return " ".join(
            f"tok{int(i)}" for i in ids if int(i) not in self._reserved
        )


class HFTokenizer:
    """Thin wrapper over a local `tokenizers` fast tokenizer file."""

    def __init__(
        self,
        tokenizer_file: str,
        pad_id: int = 0,
        eos_id: int = 0,
        eos_token: Optional[str] = None,
    ):
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(
                f"{tokenizer_file} needs the `tokenizers` package, which is not "
                "installed; install it, or remove the file to select the hash "
                "tokenizer (other token ids)"
            ) from e

        self.tk = Tokenizer.from_file(tokenizer_file)
        self.pad_id = pad_id
        self.eos_token = eos_token
        # the real eos id comes from the vocabulary when a token string is
        # given (e.g. Qwen's <|im_end|> = 151645)
        resolved = (
            self.tk.token_to_id(eos_token) if eos_token is not None else None
        )
        self.eos_id = resolved if resolved is not None else eos_id

    def encode(self, text: str, max_len: int):
        ids = self.tk.encode(text).ids[:max_len]
        out = np.full(max_len, self.pad_id, np.int32)
        mask = np.zeros(max_len, np.int32)
        out[: len(ids)] = ids
        mask[: len(ids)] = 1
        return out, mask

    def encode_batch(self, texts, max_len: int):
        pairs = [self.encode(t, max_len) for t in texts]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def encode_pair_batch(self, pairs, max_len: int):
        """(query, doc) pairs through the tokenizer's own pair template;
        token types are all 0, as the reference returns them."""
        ids_list, masks = [], []
        for a, b in pairs:
            ids = self.tk.encode(a, b).ids[:max_len]
            row = np.full(max_len, self.pad_id, np.int32)
            m = np.zeros(max_len, np.int32)
            row[: len(ids)] = ids
            m[: len(ids)] = 1
            ids_list.append(row)
            masks.append(m)
        tt = np.zeros((len(pairs), max_len), np.int32)
        return np.stack(ids_list), np.stack(masks), tt

    def decode(self, ids) -> str:
        return self.tk.decode([int(i) for i in ids], skip_special_tokens=True)


def make_tokenizer(
    model_name: str,
    weights_dir: Optional[str],
    *,
    vocab_size: int,
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    eos_token: Optional[str] = None,
):
    """Prefer a local HF tokenizer.json next to the weights; else hash."""
    if weights_dir:
        cand = os.path.join(
            weights_dir, model_name.replace("/", "__"), "tokenizer.json"
        )
        if os.path.exists(cand):
            return HFTokenizer(
                cand, pad_id=pad_id, eos_id=eos_id or pad_id,
                eos_token=eos_token,
            )
    return HashTokenizer(
        vocab_size=vocab_size, pad_id=pad_id, eos_id=eos_id,
        eos_token=eos_token,
    )
