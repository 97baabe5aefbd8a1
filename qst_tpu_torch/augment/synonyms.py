"""Synonym-replacement augmentation — a host copy of
``qst_tpu/augment/synonyms.py`` (``tests/test_torch_augment.py`` holds it to
its source), which probes for WordNet once a process (``_WORDNET``).

Equivalent of the reference's ``nlpaug.SynonymAug(aug_src='wordnet', aug_min=1,
aug_max=MAX_WORDS_TO_REPLACE, stopwords=NO_REPLACE_WORDS)`` usage
(reference positive_examples_selection.py:169-175,
partially_positive_examples_selection.py:133-141): replace between ``aug_min``
and ``aug_max`` eligible words with synonyms, never touching the stopword
list.

Zero-egress design: a built-in caption-domain synonym lexicon is the default
source; when an nltk WordNet corpus is installed it is used transparently.
The lexicon is pluggable so users can drop in their own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from qst_tpu_torch.core.config import MAX_WORDS_TO_REPLACE, NO_REPLACE_WORDS

# Compact caption-domain synonym lexicon (bidirectional closure applied at
# load). Enough coverage for COCO-caption-style text; WordNet supersedes it
# when available.
_BASE_LEXICON: Dict[str, List[str]] = {
    "big": ["large", "huge", "giant"],
    "small": ["little", "tiny", "miniature"],
    "man": ["male", "gentleman", "guy"],
    "woman": ["female", "lady"],
    "child": ["kid", "youngster"],
    "person": ["individual", "human"],
    "people": ["persons", "individuals", "crowd"],
    "picture": ["photo", "image", "photograph"],
    "street": ["road", "roadway", "avenue"],
    "car": ["automobile", "vehicle"],
    "bicycle": ["bike", "cycle"],
    "plane": ["airplane", "aircraft", "jet"],
    "boat": ["ship", "vessel"],
    "dog": ["canine", "hound", "puppy"],
    "cat": ["feline", "kitty", "kitten"],
    "bird": ["fowl"],
    "horse": ["pony", "stallion"],
    "house": ["home", "dwelling", "residence"],
    "building": ["structure", "edifice"],
    "table": ["desk", "counter"],
    "couch": ["sofa", "settee"],
    "food": ["meal", "dish", "cuisine"],
    "plate": ["dish", "platter"],
    "cup": ["mug", "glass"],
    "walk": ["stroll", "amble"],
    "walking": ["strolling", "ambling"],
    "run": ["sprint", "dash", "jog"],
    "running": ["sprinting", "dashing", "jogging"],
    "jump": ["leap", "hop"],
    "jumping": ["leaping", "hopping"],
    "sit": ["rest", "perch"],
    "sitting": ["resting", "perching", "seated"],
    "stand": ["pose"],
    "standing": ["posing", "upright"],
    "look": ["gaze", "stare", "glance"],
    "looking": ["gazing", "staring", "glancing"],
    "hold": ["grip", "grasp", "clutch"],
    "holding": ["gripping", "grasping", "clutching"],
    "ride": ["mount"],
    "riding": ["mounted on"],
    "eat": ["consume", "devour"],
    "eating": ["consuming", "devouring"],
    "play": ["frolic"],
    "playing": ["frolicking"],
    "fast": ["quick", "rapid", "swift"],
    "slow": ["sluggish", "leisurely"],
    "happy": ["glad", "joyful", "cheerful"],
    "beautiful": ["pretty", "lovely", "gorgeous"],
    "old": ["aged", "elderly", "ancient"],
    "young": ["youthful", "juvenile"],
    "red": ["crimson", "scarlet"],
    "blue": ["azure", "navy"],
    "green": ["emerald", "verdant"],
    "near": ["close to", "beside"],
    "field": ["meadow", "pasture"],
    "forest": ["woods", "woodland"],
    "mountain": ["peak", "summit"],
    "ocean": ["sea"],
    "beach": ["shore", "seashore", "seaside"],
    "road": ["street", "roadway"],
    "grass": ["lawn", "turf"],
    "sky": ["heavens"],
    "water": ["liquid"],
    "group": ["bunch", "cluster", "gathering"],
    "several": ["numerous", "various"],
    "many": ["numerous", "plenty of"],
    "top": ["summit", "peak"],
    "front": ["fore"],
    "wearing": ["dressed in", "sporting"],
    "carrying": ["transporting", "hauling"],
    "flying": ["soaring", "gliding"],
    "driving": ["steering", "operating"],
}


def _closure(base: Dict[str, List[str]]) -> Dict[str, List[str]]:
    out: Dict[str, Set[str]] = {}
    for word, syns in base.items():
        group = {word, *syns}
        for w in group:
            out.setdefault(w, set()).update(group - {w})
    return {w: sorted(s) for w, s in out.items()}


DEFAULT_LEXICON = _closure(_BASE_LEXICON)


# Whether nltk's WordNet may be there: probed once a process, not once a
# word (``pos_tagger._NLTK`` says why), the one difference from qst_tpu's copy
_WORDNET = {"usable": True}


def _wordnet_synonyms(word: str) -> List[str]:
    if not _WORDNET["usable"]:
        return []
    try:
        from nltk.corpus import wordnet

        syns = set()
        for synset in wordnet.synsets(word):
            for lemma in synset.lemmas():
                name = lemma.name().replace("_", " ")
                if name.lower() != word.lower():
                    syns.add(name)
        return sorted(syns)
    except (ImportError, LookupError):
        _WORDNET["usable"] = False
        return []


class SynonymAugmenter:
    """nlpaug.SynonymAug-equivalent with aug_min/aug_max/stopwords semantics."""

    def __init__(
        self,
        aug_min: int = 1,
        aug_max: int = MAX_WORDS_TO_REPLACE,
        stopwords: Sequence[str] = tuple(NO_REPLACE_WORDS),
        lexicon: Optional[Dict[str, List[str]]] = None,
        use_wordnet: bool = True,
        seed: int = 14,
    ):
        if aug_min < 0 or aug_max < aug_min:
            raise ValueError(f"invalid aug range [{aug_min}, {aug_max}]")
        self.aug_min = aug_min
        self.aug_max = aug_max
        self.stopwords = {w.lower() for w in stopwords}
        self.lexicon = lexicon if lexicon is not None else DEFAULT_LEXICON
        self.use_wordnet = use_wordnet
        self._rng = np.random.default_rng(seed)

    def _synonyms(self, word: str) -> List[str]:
        lower = word.lower()
        if self.use_wordnet:
            wn = _wordnet_synonyms(lower)
            if wn:
                return wn
        return self.lexicon.get(lower, [])

    def augment_one(self, text: str) -> str:
        words = text.split(" ")
        candidates = [
            i for i, w in enumerate(words)
            if w.lower() not in self.stopwords and self._synonyms(w)
        ]
        if not candidates:
            return text
        n = int(self._rng.integers(self.aug_min,
                                   min(self.aug_max, len(candidates)) + 1))
        n = max(min(n, len(candidates)), min(self.aug_min, len(candidates)))
        if n == 0:
            return text
        chosen = self._rng.choice(len(candidates), size=n, replace=False)
        for c in chosen:
            i = candidates[int(c)]
            syns = self._synonyms(words[i])
            replacement = syns[int(self._rng.integers(0, len(syns)))]
            # preserve leading capitalization
            if words[i][:1].isupper():
                replacement = replacement[:1].upper() + replacement[1:]
            words[i] = replacement
        return " ".join(words)

    def augment(self, texts) -> List[str]:
        if isinstance(texts, str):
            texts = [texts]
        return [self.augment_one(t) for t in texts]
