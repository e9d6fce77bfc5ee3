"""Text analysis and the token stages: the port's copy of ``analyze``,
``TextTokenizer``, ``OpCountVectorizer`` and ``OpCountVectorizerModel`` from
``transmogrifai_tpu/impl/feature/text.py`` (reference LuceneTextAnalyzer:87,
TextTokenizer.scala:125, OpCountVectorizer.scala:44): NFC normalize ->
lowercase -> unicode word split -> min token length -> per-language
stopwords, and the vocabulary term counts.  Host code, bit-equal to the JAX
package's; the count matrix goes to the stage's device.  Language
auto-detection (the trigram profiles of ``models/``) is not ported: the
tokenizer raises with ``auto_detect_language=True``.
"""
from __future__ import annotations

import re
import unicodedata
from collections import Counter
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ... import types as T
from ...columns import Column, Dataset, ObjectColumn, VectorColumn
from ...features.metadata import VectorColumnMetadata
from ...stages.base import Model, UnaryEstimator, UnaryTransformer
from ._util import finalize_vector

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


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------
class TextTokenizer(UnaryTransformer):
    """Text -> TextList tokens (TextTokenizer.scala:125), the analysis chain
    of ``analyze`` with the stage's language and options."""

    def __init__(self, language: str = DEFAULT_LANGUAGE, min_token_length: int = 1,
                 to_lowercase: bool = True, filter_stopwords: bool = True,
                 auto_detect_language: bool = False, auto_detect_threshold: float = 0.15,
                 uid: Optional[str] = None):
        super().__init__(operation_name="textToken", input_type=T.Text,
                         output_type=T.TextList, uid=uid,
                         language=language, min_token_length=min_token_length,
                         to_lowercase=to_lowercase, filter_stopwords=filter_stopwords,
                         auto_detect_language=auto_detect_language,
                         auto_detect_threshold=auto_detect_threshold)

    def tokenize(self, text: Optional[str]) -> List[str]:
        if self.get_param("auto_detect_language") and text:
            raise NotImplementedError("TextTokenizer(auto_detect_language=True) needs the "
                                      "language profiles, which are not ported")
        return analyze(text, language=self.get_param("language", DEFAULT_LANGUAGE),
                       min_token_length=int(self.get_param("min_token_length", 1)),
                       to_lowercase=bool(self.get_param("to_lowercase", True)),
                       remove_stops=bool(self.get_param("filter_stopwords", True)))

    def transform_fn(self, value: T.FeatureType) -> T.FeatureType:
        return T.TextList(self.tokenize(value.value))


# ---------------------------------------------------------------------------
# Count vectorization (vocabulary TF)
# ---------------------------------------------------------------------------
class OpCountVectorizer(UnaryEstimator):
    """TextList -> OPVector term counts over a fitted vocabulary
    (OpCountVectorizer.scala:44; Spark CountVectorizer semantics: the top
    ``vocab_size`` terms with document frequency >= ``min_df``, ordered by
    (-df, term))."""

    def __init__(self, vocab_size: int = 512, min_df: int = 1, binary: bool = False,
                 uid: Optional[str] = None):
        super().__init__(operation_name="countVec", input_type=T.TextList,
                         output_type=T.OPVector, uid=uid,
                         vocab_size=vocab_size, min_df=min_df, binary=binary)

    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "OpCountVectorizerModel":
        col = cols[0]
        assert isinstance(col, ObjectColumn)
        df_counts: Counter = Counter()
        for toks in col.values:
            df_counts.update(set(toks or []))
        min_df = int(self.get_param("min_df"))
        vocab = sorted(((t, c) for t, c in df_counts.items() if c >= min_df),
                       key=lambda tc: (-tc[1], tc[0]))
        return OpCountVectorizerModel(
            vocabulary=[t for t, _ in vocab[: int(self.get_param("vocab_size"))]],
            binary=bool(self.get_param("binary")), operation_name=self.operation_name,
            output_type=self.output_type)


class OpCountVectorizerModel(Model):
    def __init__(self, vocabulary: List[str], binary: bool = False,
                 operation_name: str = "countVec", output_type=T.OPVector,
                 uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.vocabulary = list(vocabulary)
        self.binary = bool(binary)

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        col = cols[0]
        assert isinstance(col, ObjectColumn)
        index = {t: j for j, t in enumerate(self.vocabulary)}
        n, k = len(col), len(self.vocabulary)
        rows, terms = [], []
        for i, toks in enumerate(col.values):
            for tok in toks or ():
                j = index.get(tok)
                if j is not None:
                    rows.append(i)
                    terms.append(j)
        out = np.zeros((n, k), dtype=np.float32)
        if self.binary:
            out[rows, terms] = 1.0
        else:
            np.add.at(out, (np.asarray(rows, np.int64), np.asarray(terms, np.int64)), 1.0)
        f = self.inputs[0]
        meta = [VectorColumnMetadata((f.name,), (f.ftype.__name__,), indicator_value=t)
                for t in self.vocabulary]
        return finalize_vector(self, [out], meta, n)
