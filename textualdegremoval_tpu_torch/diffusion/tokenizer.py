"""Self-contained CLIP BPE tokenizer (no transformers dependency).

The port's own copy of textualdegremoval_tpu/diffusion/tokenizer.py (the
port imports nothing of the JAX package).

The reference tokenizes with the SD checkpoint's own tokenizer
(scripts/train/main_train_i2t_mapping.py:556 —
``CLIPTokenizer.from_pretrained(sd_path, subfolder="tokenizer")``), whose
assets are the standard CLIP BPE ``vocab.json`` + ``merges.txt`` shipped
inside every SD 2.1 checkpoint.  This module reimplements that tokenizer in
~100 lines of pure python so pipeline A needs neither network access nor
the transformers package: point it at the checkpoint's ``tokenizer/``
directory and it produces identical ids.

Also implements the reference's placeholder-index rule
(data/guidance_generation_dataset.py:186-196): the injection index is
1 + the whitespace-word position of the placeholder — the rule the
training data pipeline itself used, which is only correct when every word
before the placeholder encodes to one BPE token; ``placeholder_index``
verifies that when a vocab is available.

Known ids used by the offline fallback (standard CLIP vocab):
BOS 49406, EOS 49407, 'a</w>' 320, 'photo</w>' 1125, 'of</w>' 539.
"""

from __future__ import annotations

import functools
import json
import os
import re

import numpy as np

BOS_ID = 49406
EOS_ID = 49407
PAD_ID = 0  # SD 2.x pads with '!' (id 0); the splice ignores pad content

_WORD_IDS = {"a": 320, "photo": 1125, "of": 539}


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2/CLIP byte -> printable-unicode map (vocab keys use this)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPBPETokenizer:
    """CLIP's SimpleTokenizer semantics, fed by HF-format assets.

    ``path`` is a directory holding ``vocab.json`` and ``merges.txt`` (the
    ``tokenizer`` subfolder of an SD checkpoint)."""

    # stdlib `re` has no \p{L}/\p{N}; [^\W\d_] matches unicode letters.
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|[^\s\w]+",
        re.IGNORECASE | re.UNICODE,
    )

    def __init__(self, path: str):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.cache: dict[str, list[str]] = {}
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)
        self.pad_id = self.encoder.get("!", PAD_ID)

    def _bpe(self, token: str) -> list[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Text -> BPE ids (no special tokens)."""
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: list[int] = []
        for token in self._PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token))
        return ids

    def __call__(self, text: str, max_length: int = 77) -> np.ndarray:
        """HF-CLIPTokenizer-compatible: BOS + ids + EOS, padded/truncated to
        max_length; returns (1, max_length) int32."""
        ids = [self.bos_id] + self.encode(text)[: max_length - 2] + \
            [self.eos_id]
        ids = ids + [self.pad_id] * (max_length - len(ids))
        return np.asarray([ids], np.int32)


def placeholder_index(template: str, placeholder: str = "S",
                      tokenizer: CLIPBPETokenizer | None = None) -> int:
    """Injection index per the reference rule
    (guidance_generation_dataset.py:186-196): 1 + whitespace-word position
    of the placeholder.  When a tokenizer is available, verifies the rule's
    premise — every word before the placeholder is a single BPE token —
    and raises if the template violates it (the reference would silently
    inject at the wrong position)."""
    words = template.split()
    idx = 0
    for i, w in enumerate(words):
        if w == placeholder:
            idx = i + 1
            break
    else:
        raise ValueError(f"placeholder {placeholder!r} not in {template!r}")
    if tokenizer is not None:
        n_tokens = len(tokenizer.encode(" ".join(words[: idx - 1])))
        if n_tokens != idx - 1:
            raise ValueError(
                f"template words before {placeholder!r} encode to "
                f"{n_tokens} tokens, not {idx - 1}: the reference's "
                "word-position rule would mis-place the injection")
    return idx


def tokenize_template(template: str, placeholder: str = "S",
                      tokenizer_path: str | None = None,
                      max_length: int = 77):
    """(input_ids, uncond_ids, inj_index) for a prompt template.

    With ``tokenizer_path`` (an SD checkpoint's ``tokenizer/`` dir), real
    BPE ids.  Without one (zero-egress rig, no checkpoint assets), falls
    back to the documented known ids for the default
    ``"a photo of a S"`` template — any other template then requires the
    real tokenizer."""
    prompt = template.replace("{}", placeholder)
    if tokenizer_path:
        tok = CLIPBPETokenizer(tokenizer_path)
        inj = placeholder_index(prompt, placeholder, tok)
        return tok(prompt, max_length), tok("", max_length), inj

    words = prompt.lower().split()
    known = [_WORD_IDS.get(w) for w in words]
    if any(k is None and w != placeholder.lower()
           for k, w in zip(known, words)):
        raise ValueError(
            f"no tokenizer assets and template {template!r} uses words "
            "outside the known-id fallback table; pass tokenizer_path")
    ids = np.full((1, max_length), PAD_ID, np.int32)
    ids[0, 0] = BOS_ID
    for i, (k, w) in enumerate(zip(known, words)):
        # the placeholder slot's id is irrelevant: the splice overwrites
        # its embedding (inj_forward_text semantics)
        ids[0, 1 + i] = BOS_ID if k is None else k
    ids[0, 1 + len(words)] = EOS_ID
    uncond = np.full((1, max_length), PAD_ID, np.int32)
    uncond[0, 0] = BOS_ID
    uncond[0, 1] = EOS_ID
    return ids, uncond, placeholder_index(prompt, placeholder)
