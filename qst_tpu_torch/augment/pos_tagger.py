"""Universal-tagset POS tagging for caption cropping — a host copy of
``qst_tpu/augment/pos_tagger.py`` (``tests/test_torch_augment.py`` holds it
to its source), which probes for nltk once a process (``_NLTK``).

The reference uses nltk's perceptron tagger (+ punkt tokenizer) downloaded at
import time (reference dataset/__init__.py:9-13, consumed at
partially_positive_examples_selection.py:62). This environment is zero-egress,
so the framework ships a self-contained rule-based tagger producing the same
universal tagset (NOUN, VERB, DET, ADJ, ADP, PRON, ADV, CONJ, NUM, PRT, '.',
X). Accuracy on caption-style text is what the crop algorithm needs: it only
distinguishes NOUN/VERB/DET boundaries and punctuation.

When an nltk installation with the required data IS present,
``pos_tag_universal`` transparently delegates to it.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from qst_tpu_torch.models.tokenizer import basic_tokenize

# closed-class lexicons (universal tagset)
_DET = {"a", "an", "the", "this", "that", "these", "those", "each", "every",
        "some", "any", "no", "another", "both", "all", "few", "many", "several"}
_ADP = {"in", "on", "at", "by", "for", "with", "about", "against", "between",
        "into", "through", "during", "before", "after", "above", "below",
        "to", "from", "up", "down", "of", "off", "over", "under", "near",
        "behind", "beside", "around", "along", "across", "inside", "outside",
        "onto", "upon", "within", "without", "toward", "towards"}
_PRON = {"i", "you", "he", "she", "it", "we", "they", "me", "him", "her",
         "us", "them", "my", "your", "his", "its", "our", "their", "mine",
         "yours", "hers", "ours", "theirs", "who", "whom", "whose", "which",
         "what", "himself", "herself", "itself", "themselves", "someone",
         "something", "anyone", "anything", "everyone", "everything"}
_CONJ = {"and", "or", "but", "nor", "so", "yet", "because", "although",
         "while", "if", "unless", "since", "whereas", "whether"}
_AUX_VERBS = {"is", "are", "was", "were", "be", "been", "being", "am",
              "has", "have", "had", "having", "do", "does", "did", "doing",
              "can", "could", "will", "would", "shall", "should", "may",
              "might", "must", "sits", "sit"}
_ADV = {"very", "quite", "rather", "too", "also", "just", "only", "not",
        "never", "always", "often", "sometimes", "usually", "here", "there",
        "now", "then", "again", "almost", "already", "still", "together",
        "away", "back", "out"}
_PRT = {"'s", "n't", "'ll", "'re", "'ve", "'d", "'m"}
_NUM_WORDS = {"one", "two", "three", "four", "five", "six", "seven", "eight",
              "nine", "ten", "zero", "dozen", "hundred", "thousand", "million"}

_ADJ_SUFFIXES = ("ous", "ful", "less", "ish", "ive", "able", "ible", "al",
                 "ic", "ical", "ian", "ary", "like")
_ADV_SUFFIXES = ("ly",)
_VERB_SUFFIXES = ("ing", "ed", "ify", "ize", "ise", "ate")
_NOUN_SUFFIXES = ("tion", "sion", "ment", "ness", "ity", "ship", "hood",
                  "er", "or", "ist", "ism", "ance", "ence", "age", "ure")

# common caption-domain verbs whose base forms lack a suffix signal
_COMMON_VERBS = {"run", "runs", "ran", "walk", "walks", "walked", "stand",
                 "stands", "stood", "sit", "sits", "sat", "hold", "holds",
                 "held", "ride", "rides", "rode", "fly", "flies", "flew",
                 "eat", "eats", "ate", "drink", "drinks", "look", "looks",
                 "play", "plays", "wear", "wears", "wore", "drive", "drives",
                 "drove", "jump", "jumps", "watch", "watches", "catch",
                 "catches", "throw", "throws", "threw", "carry", "carries",
                 "lie", "lies", "lay", "lays", "hang", "hangs", "hung",
                 "rest", "rests", "sleep", "sleeps", "swim", "swims", "go",
                 "goes", "went", "come", "comes", "came", "make", "makes",
                 "made", "take", "takes", "took", "get", "gets", "got"}

_PUNCT_RE = re.compile(r"^\W+$")
_NUM_RE = re.compile(r"^\d+([.,]\d+)?$")


def _tag_word(word: str, prev_tag: str) -> str:
    lower = word.lower()
    if _PUNCT_RE.match(word):
        return "."
    if _NUM_RE.match(word) or lower in _NUM_WORDS:
        return "NUM"
    if lower in _DET:
        return "DET"
    if lower in _ADP:
        return "ADP"
    if lower in _PRON:
        return "PRON"
    if lower in _CONJ:
        return "CONJ"
    if lower in _PRT:
        return "PRT"
    if lower in _AUX_VERBS or lower in _COMMON_VERBS:
        return "VERB"
    if lower in _ADV or lower.endswith(_ADV_SUFFIXES):
        return "ADV"
    # suffix heuristics, order matters: -ing/-ed after DET reads nominal/adj
    if lower.endswith(_VERB_SUFFIXES):
        if prev_tag in ("DET", "ADJ", "NUM"):
            return "ADJ" if lower.endswith(("ing", "ed")) else "NOUN"
        return "VERB"
    if lower.endswith(_ADJ_SUFFIXES) and prev_tag in ("DET", "ADV", "VERB", ""):
        return "ADJ"
    return "NOUN"


# Whether nltk's tagger may be there. Python does not remember a failed
# import (each retry searches the whole import path again), and nltk without
# its data searches its data paths on every lookup; the one difference from
# qst_tpu's copy is that the probe fails once a process, not once a caption.
_NLTK = {"usable": True}


def pos_tag_universal(text: str) -> List[Tuple[str, str]]:
    """→ [(word, universal_tag)], delegating to nltk when its data exists."""
    if _NLTK["usable"]:
        try:  # optional nltk fast path (requires downloaded corpora)
            from nltk import pos_tag
            from nltk.tokenize import word_tokenize

            return pos_tag(word_tokenize(text), tagset="universal")
        except (LookupError, ImportError):
            _NLTK["usable"] = False
    words = basic_tokenize(text, lowercase=False)
    tags: List[Tuple[str, str]] = []
    prev = ""
    for w in words:
        t = _tag_word(w, prev)
        tags.append((w, t))
        prev = t
    return tags
