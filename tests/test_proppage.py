"""Settings property-page model (Source/PropPage.cpp analogue)."""

import dataclasses

from videorenderer.config import (HdrToggleDisplay, Settings, ToneMapType,
                                      Upscaling)
from videorenderer.proppage import FIELDS, PropertyPageModel


def spec(name):
    return next(f for f in FIELDS if f.name == name)


def test_covers_every_settings_field():
    """Every Settings field (and VPEnableFormats subfield) has a page row."""
    page = {f.name.split(".")[0] for f in FIELDS}
    fields = {f.name for f in dataclasses.fields(Settings)}
    assert fields <= page, fields - page
    vp = {f.name for f in FIELDS if f.name.startswith("vp_formats.")}
    assert vp == {"vp_formats.nv12", "vp_formats.p01x",
                  "vp_formats.yuy2", "vp_formats.other"}


def test_toggle_and_dirty():
    m = PropertyPageModel(Settings())
    assert not m.dirty
    m.toggle(spec("use_dither"))
    assert m.dirty and m.value.use_dither is False
    m.cancel()
    assert not m.dirty and m.value.use_dither is True


def test_enum_cycle_and_int_step():
    m = PropertyPageModel(Settings())
    m.step(spec("upscaling"), +1)
    assert m.value.upscaling == Upscaling(int(Settings().upscaling) + 1)
    # int stepping honors the 5-nit slider step and the range clamp
    m.step(spec("sdr_display_nits"), +1)
    assert m.value.sdr_display_nits == Settings().sdr_display_nits + 5
    for _ in range(200):
        m.step(spec("sdr_display_nits"), -1)
    assert m.value.sdr_display_nits == 25  # SDR_NITS_MIN


def test_dependency_rules():
    """The EnableWindow graph: VP rows grey out with the backend off,
    tone-map rows with local tone mapping off (PropPage.cpp:141-176)."""
    m = PropertyPageModel(Settings(use_accel_backend=False))
    assert not m.enabled(spec("vp_formats.nv12"))
    assert not m.enabled(spec("vp_superres"))
    v = m.value.vp_formats.nv12
    m.toggle(spec("vp_formats.nv12"))           # disabled -> no-op
    assert m.value.vp_formats.nv12 == v
    m2 = PropertyPageModel(Settings(hdr_local_tone_mapping=False))
    assert not m2.enabled(spec("hdr_display_max_nits"))
    m3 = PropertyPageModel(Settings(hdr_local_tone_mapping=True))
    assert m3.enabled(spec("hdr_display_max_nits"))


def test_subfield_set_and_apply_callback():
    applied = []
    m = PropertyPageModel(Settings(), on_apply=applied.append)
    m.set_value("vp_formats.yuy2", False)
    m.set_value("hdr_local_tone_mapping_type", int(ToneMapType.BT2390))
    m.set_value("hdr_display_max_nits", 99999)   # clamps to page range
    out = m.apply()
    assert applied == [out]
    assert out.vp_formats.yuy2 is False
    assert out.hdr_local_tone_mapping_type == ToneMapType.BT2390
    assert out.hdr_display_max_nits == 10000
    assert not m.dirty


def test_reset_to_defaults():
    m = PropertyPageModel(Settings(show_stats=True,
                                   hdr_toggle_display=HdrToggleDisplay.ON))
    m.reset()
    assert m.value == Settings()


def test_display_strings():
    m = PropertyPageModel(Settings())
    assert m.display(spec("use_dither")) == "[x]"
    assert m.display(spec("upscaling")) == "CATMULL_ROM"
    assert m.display(spec("sdr_display_nits")) == "125"


def test_info_page_model_lazy_scroll_refresh():
    """Info page (CVRInfoPPage analogue): provider is called lazily on first
    view, refresh re-queries it, and scrolling clamps at both ends."""
    from videorenderer.proppage import InfoPageModel
    calls = []

    def provider():
        calls.append(1)
        return "\n".join(f"line{i}" for i in range(5))

    m = InfoPageModel(provider)
    assert calls == []                     # lazy: no probe yet
    assert m.visible(2) == ["line0", "line1"]
    assert calls == [1]
    m.scroll_by(3)
    assert m.visible(2) == ["line3", "line4"]
    m.scroll_by(10)                        # clamps to last line
    assert m.scroll == 4
    m.scroll_by(-99)
    assert m.scroll == 0
    m.refresh()
    assert calls == [1, 1]


def test_info_page_model_provider_error():
    from videorenderer.proppage import InfoPageModel
    m = InfoPageModel(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    assert "info unavailable" in m.visible(1)[0]


def test_info_page_model_renderer_report():
    """The CLI wires the page to GetVPInfo; the report renders for a plain
    Settings value without an open media type."""
    from videorenderer.api import VideoRenderer
    from videorenderer.proppage import InfoPageModel
    m = InfoPageModel(
        lambda: VideoRenderer(Settings()).get_video_processor_info())
    assert any("videorenderer" in ln for ln in m.visible(10))
