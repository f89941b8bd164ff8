"""The LM framework layer's serving path: config dataclasses and init
(`common`), blocks (`layers`) and model assembly (`model`)."""
