"""Feature-engineering stages (core/.../stages/impl/feature analog)."""
from .embeddings import OpLDA, OpLDAModel, OpWord2Vec, OpWord2VecModel
from .text import OpCountVectorizer, OpCountVectorizerModel, TextTokenizer
