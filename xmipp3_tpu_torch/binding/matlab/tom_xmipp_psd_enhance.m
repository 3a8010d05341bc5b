function img_out = tom_xmipp_psd_enhance(img, center, take_log, ...
    filter_w1, filter_w2, decay_width, mask_w1, mask_w2)
%TOM_XMIPP_PSD_ENHANCE enhance a periodogram for display/fitting (log,
%median, band-pass, annular mask, normalization).
%Replaces tom_xmipp_psd_enhance.cpp.
if nargin < 8, mask_w2 = 0.2; end
if nargin < 7, mask_w1 = 0.025; end
if nargin < 6, decay_width = 0.02; end
if nargin < 5, filter_w2 = 0.2; end
if nargin < 4, filter_w1 = 0.05; end
if nargin < 3, take_log = true; end
if nargin < 2, center = true; end
out = xmipp_matlab_bridge('psd_enhance', struct('img', img, ...
    'center', center, 'take_log', take_log, 'filter_w1', filter_w1, ...
    'filter_w2', filter_w2, 'decay_width', decay_width, ...
    'mask_w1', mask_w1, 'mask_w2', mask_w2));
img_out = out.img_out;
end
