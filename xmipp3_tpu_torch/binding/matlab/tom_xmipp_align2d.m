function st = tom_xmipp_align2d(img, ref, mode, max_shift, max_rot, ...
    psi_interval, Rin, Rout, outside)
%TOM_XMIPP_ALIGN2D align IMG to REF: MODE 'rot', 'trans' or 'complete'
%(default). Returns struct with Xoff, Yoff, Psi and the 3x3 Tform.
%Replaces tom_xmipp_align2d.cpp.
if nargin < 9, outside = 0; end
if nargin < 8, Rout = 0; end
if nargin < 7, Rin = 0; end
if nargin < 6, psi_interval = 10; end
if nargin < 5, max_rot = 0; end
if nargin < 4, max_shift = 0; end
if nargin < 3, mode = 'complete'; end
st = xmipp_matlab_bridge('align2d', struct('img', img, 'ref', ref, ...
    'mode', mode, 'max_shift', max_shift, 'max_rot', max_rot, ...
    'psi_interval', psi_interval, 'Rin', Rin, 'Rout', Rout, ...
    'outside', outside));
end
