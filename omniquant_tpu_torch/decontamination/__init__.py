from .janitor import Janitor, word_ngrams
from .decontaminate import get_train_overlap, get_train_overlap_stub
