"""Text analysis for hashing: the port's copy of ``analyze`` from
``transmogrifai_tpu/impl/feature/text.py`` (reference LuceneTextAnalyzer:87):
NFC normalize -> lowercase -> unicode word split -> min token length ->
per-language stopwords.  The text stages themselves are not ported.
"""
from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Optional, Set

# ---------------------------------------------------------------------------
# Analyzers (LuceneTextAnalyzer analog)
# ---------------------------------------------------------------------------
_WORD_RE = re.compile(r"\w+", re.UNICODE)

# Minimal per-language stopword lists (Lucene's default analyzers ship the
# same concept; lists abbreviated to the high-frequency heads).
STOP_WORDS: Dict[str, Set[str]] = {
    "en": {"a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
           "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
           "that", "the", "their", "then", "there", "these", "they", "this",
           "to", "was", "will", "with"},
    "fr": {"au", "aux", "avec", "ce", "ces", "dans", "de", "des", "du", "elle",
           "en", "et", "eux", "il", "je", "la", "le", "les", "leur", "lui",
           "ma", "mais", "me", "même", "mes", "moi", "mon", "ne", "nos",
           "notre", "nous", "on", "ou", "par", "pas", "pour", "qu", "que",
           "qui", "sa", "se", "ses", "son", "sur", "ta", "te", "tes", "toi",
           "ton", "tu", "un", "une", "vos", "votre", "vous"},
    "de": {"aber", "als", "am", "an", "auch", "auf", "aus", "bei", "bin",
           "bis", "bist", "da", "damit", "das", "dass", "dein", "deine",
           "dem", "den", "der", "des", "dessen", "die", "dir", "du", "ein",
           "eine", "einem", "einen", "einer", "eines", "er", "es", "für",
           "hatte", "hatten", "hattest", "hattet", "hier", "hinter", "ich",
           "ihr", "ihre", "im", "in", "ist", "ja", "jede", "jedem", "jeden",
           "jeder", "jedes", "jener", "jenes", "jetzt", "kann", "kannst",
           "können", "könnt", "machen", "mein", "meine", "mit", "muss",
           "musst", "müssen", "müsst", "nach", "nachdem", "nein", "nicht",
           "nun", "oder", "seid", "sein", "seine", "sich", "sie", "sind",
           "soll", "sollen", "sollst", "sollt", "sonst", "soweit", "sowie",
           "und", "unser", "unsere", "unter", "vom", "von", "vor", "wann",
           "warum", "was", "weiter", "weitere", "wenn", "wer", "werde",
           "werden", "werdet", "weshalb", "wie", "wieder", "wieso", "wir",
           "wird", "wirst", "wo", "woher", "wohin", "zu", "zum", "zur",
           "über"},
    "es": {"a", "al", "algo", "algunas", "algunos", "ante", "antes", "como",
           "con", "contra", "cual", "cuando", "de", "del", "desde", "donde",
           "durante", "e", "el", "ella", "ellas", "ellos", "en", "entre",
           "era", "es", "esa", "ese", "eso", "esta", "este", "esto", "la",
           "las", "le", "les", "lo", "los", "me", "mi", "mis", "mucho",
           "muchos", "muy", "más", "ni", "no", "nos", "nosotros", "o",
           "otra", "otros", "para", "pero", "poco", "por", "porque", "que",
           "quien", "se", "sin", "sobre", "son", "su", "sus", "también",
           "tanto", "te", "tiene", "toda", "todos", "tu", "un", "una",
           "uno", "unos", "y", "ya", "yo"},
}
DEFAULT_LANGUAGE = "en"
MIN_TOKEN_LENGTH = 1


def analyze(text: Optional[str], language: str = DEFAULT_LANGUAGE,
            min_token_length: int = MIN_TOKEN_LENGTH,
            to_lowercase: bool = True, remove_stops: bool = True) -> List[str]:
    """Default analysis chain: NFC normalize -> lowercase -> unicode word
    split -> min length -> per-language stopwords."""
    if not text:
        return []
    s = unicodedata.normalize("NFC", text)
    if to_lowercase:
        s = s.lower()
    tokens = _WORD_RE.findall(s)
    if min_token_length > 1:
        tokens = [t for t in tokens if len(t) >= min_token_length]
    if remove_stops:
        stops = STOP_WORDS.get(language, set())
        if stops:
            tokens = [t for t in tokens if t not in stops]
    return tokens
