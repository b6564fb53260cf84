"""The text front-end (G2P, symbol table, TextGrid reader), a copy of
``megatts2_tpu/text`` kept in the port so that it imports nothing of the
JAX package.  ``mandarin_pinyin_to_mfa.dict`` is the bundled dictionary
that ``pinyin_dict.default_dict_path()`` resolves beside this file."""
from .symbol_table import SymbolTable
from .textgrid import Entry, read_textgrid
from .tokenizer import TextTokenizer, load_pinyin_dict
