"""Robustness layer of the port. So far the input contract
(``robust.contract``); retry, the robustness log, integrity checks, fault
injection and the elastic mesh are not ported yet."""
