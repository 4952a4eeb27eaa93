"""Headless stand-in for the streamlit module (a copy of
:mod:`tnmf_tpu.utils._st_shim`, so the port's demos run without JAX).

The demo suite renders through streamlit when it is installed; in headless
environments (CI, tests, batch runs) this shim supplies the same widget API
with every widget returning its default value and every render call being a
no-op.  That keeps the demo logic executable and testable without the
dependency (the reference library's demos import streamlit unconditionally
and cannot run headless).
"""

from __future__ import annotations


class _Progress:
    def progress(self, value):  # noqa: D102
        return None


class StreamlitShim:
    """Duck-typed subset of the streamlit API used by the demos."""

    def __init__(self):
        self.sidebar = self

    # ---- widgets: return their defaults -------------------------------
    @staticmethod
    def selectbox(label, options, index=0, **_):
        return list(options)[index]

    @staticmethod
    def radio(label, options, index=0, **_):
        return list(options)[index]

    @staticmethod
    def number_input(label, min_value=None, max_value=None, value=0, **_):
        return value

    @staticmethod
    def slider(label, min_value=None, max_value=None, value=None, **_):
        if value is None:
            return min_value if min_value is not None else 0
        return value

    @staticmethod
    def checkbox(label, value=False, **_):
        return value

    @staticmethod
    def text_input(label, value='', **_):
        return value

    @staticmethod
    def multiselect(label, options, default=None, **_):
        return list(default) if default is not None else list(options)

    def progress(self, value, **_):
        return _Progress()

    # ---- render calls: no-ops -----------------------------------------
    @staticmethod
    def _noop(*args, **kwargs):
        return None

    markdown = caption = write = title = header = subheader = image = _noop

    @staticmethod
    def pyplot(fig=None, **_):
        # release the figure so headless demo sweeps do not accumulate memory
        if fig is not None:
            import matplotlib.pyplot as plt
            plt.close(fig)

    # ---- caching decorators: pass-through -----------------------------
    @staticmethod
    def cache_data(func=None, **kwargs):
        if func is None:
            return lambda f: f
        return func

    cache = cache_resource = cache_data

    @staticmethod
    def columns(n, **_):
        count = n if isinstance(n, int) else len(n)
        return [StreamlitShim() for _ in range(count)]

    # ---- layout context manager (``with st.columns(3)[0]: ...``) ------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def get_streamlit():
    """The real streamlit if importable, else the shim (plus a flag)."""
    try:
        import streamlit
        return streamlit, True
    except ImportError:
        return StreamlitShim(), False
