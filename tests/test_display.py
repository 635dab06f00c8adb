"""Display config / HDR toggle policy tests (HandleHDRToggle port)."""

from videorenderer.config import HdrToggleDisplay
from videorenderer.display import DisplayConfig, HdrToggleController


def _ctl(hdr_enabled=False, hdr_supported=True):
    return HdrToggleController(DisplayConfig(hdr_enabled=hdr_enabled,
                                             hdr_supported=hdr_supported))


def test_disabled_policy_never_toggles():
    c = _ctl()
    assert not c.evaluate(HdrToggleDisplay.DISABLED, source_is_hdr=True)
    assert not c.display.hdr_enabled


def test_on_policy_turns_on_not_off():
    c = _ctl()
    assert c.evaluate(HdrToggleDisplay.ON, source_is_hdr=True)
    assert c.display.hdr_enabled
    # ON policy does not switch off for SDR sources
    assert not c.evaluate(HdrToggleDisplay.ON, source_is_hdr=False)
    assert c.display.hdr_enabled


def test_onoff_policy_round_trip():
    c = _ctl()
    assert c.evaluate(HdrToggleDisplay.ONOFF, source_is_hdr=True)
    assert c.display.hdr_enabled
    assert c.evaluate(HdrToggleDisplay.ONOFF, source_is_hdr=False)
    assert not c.display.hdr_enabled


def test_fullscreen_gating():
    c = _ctl()
    assert not c.evaluate(HdrToggleDisplay.ON_FULLSCREEN, True, fullscreen=False)
    assert c.evaluate(HdrToggleDisplay.ON_FULLSCREEN, True, fullscreen=True)


def test_unsupported_display():
    c = _ctl(hdr_supported=False)
    assert not c.evaluate(HdrToggleDisplay.ON, source_is_hdr=True)


def test_restore():
    c = _ctl(hdr_enabled=False)
    c.evaluate(HdrToggleDisplay.ON, source_is_hdr=True)
    assert c.display.hdr_enabled
    c.restore()
    assert not c.display.hdr_enabled


def test_refresh_rate():
    d = DisplayConfig(refresh_num=60000, refresh_den=1001)
    assert abs(d.refresh_hz - 59.94) < 0.01
